"""Aircraft kinematics: airspeed/heading/VS dynamics + position integration.

Port of ``bluesky_tpu/core/kinematics.py`` (reference
``Traffic.UpdateAirSpeed / UpdateGroundSpeed / UpdatePosition``), with
the differentiable relaxation of the airspeed dynamics
(``SimConfig.smooth``, ``diff/smooth.py``).
"""
import torch

from ..ops import aero, geo, ties


def update_airspeed(ac, pilot, accel, simdt, eps=0.01, smooth=None):
    """TAS/heading/VS dynamics toward the pilot targets.  The hard
    dynamics are bang-bang (``sign(error) * rate`` under a dead-band),
    with zero gradient in the targets; with ``smooth`` (a
    ``diff.smooth.SmoothConfig``) each capture is a straight-through
    clipped proportional step (``_update_airspeed_smooth``)."""
    if smooth is not None:
        return _update_airspeed_smooth(ac, pilot, accel, simdt, eps)
    delta_spd = pilot.tas - ac.tas
    need_ax = torch.abs(delta_spd) > aero.kts
    ax = need_ax * torch.sign(delta_spd) * accel
    tas = ac.tas + ax * simdt
    cas = aero.vtas2cas(tas, ac.alt)
    mach = aero.vtas2mach(tas, ac.alt)

    turnrate = geo.degrees(aero.g0 * torch.tan(ac.bank)
                           / ties.maximum(tas, eps))
    delhdg = (pilot.hdg - ac.hdg + 180.0) % 360.0 - 180.0
    swhdgsel = torch.abs(delhdg) > torch.abs(2.0 * simdt * turnrate)
    hdg = (ac.hdg + simdt * turnrate * swhdgsel * torch.sign(delhdg)) % 360.0

    delta_alt = pilot.alt - ac.alt
    swaltsel = torch.abs(delta_alt) > torch.clamp_min(
        torch.abs(2.0 * simdt * torch.abs(ac.vs)), 10.0 * aero.ft)
    target_vs = swaltsel * torch.sign(delta_alt) * torch.abs(pilot.vs)
    delta_vs = target_vs - ac.vs
    need_az = torch.abs(delta_vs) > 300.0 * aero.fpm
    az = need_az * torch.sign(delta_vs) * (300.0 * aero.fpm)
    vs = torch.where(need_az, ac.vs + az * simdt, target_vs)
    vs = torch.where(torch.isfinite(vs), vs, torch.zeros_like(vs))
    return ac.replace(tas=tas, cas=cas, mach=mach, hdg=hdg, vs=vs, ax=ax,
                      swhdgsel=swhdgsel, swaltsel=swaltsel)


def _update_airspeed_smooth(ac, pilot, accel, simdt, eps):
    """The differentiable relaxation of ``update_airspeed``: each
    bang-bang capture becomes ``capture_step``, the same saturated rate
    toward the target with exact capture instead of dead-band chatter
    and a straight-through backward."""
    from ..diff.smooth import capture_step

    delta_spd = pilot.tas - ac.tas
    dtas = capture_step(delta_spd, accel * simdt)
    tas = ac.tas + dtas
    ax = dtas / simdt
    cas = aero.vtas2cas(tas, ac.alt)
    mach = aero.vtas2mach(tas, ac.alt)

    turnrate = geo.degrees(aero.g0 * torch.tan(ac.bank)
                           / ties.maximum(tas, eps))
    delhdg = (pilot.hdg - ac.hdg + 180.0) % 360.0 - 180.0
    swhdgsel = torch.abs(delhdg) > torch.abs(2.0 * simdt * turnrate)
    hdg = (ac.hdg + capture_step(delhdg, simdt * turnrate)) % 360.0

    # VS toward the rate that closes the altitude error in one step,
    # capped at the commanded |pilot.vs|; VS itself slews at 300 fpm/s
    delta_alt = pilot.alt - ac.alt
    swaltsel = torch.abs(delta_alt) > ties.maximum(
        torch.abs(2.0 * simdt * torch.abs(ac.vs)), 10.0 * aero.ft)
    target_vs = capture_step(delta_alt / simdt, torch.abs(pilot.vs))
    vs = ac.vs + capture_step(target_vs - ac.vs, 300.0 * aero.fpm * simdt)
    vs = torch.where(torch.isfinite(vs), vs, torch.zeros_like(vs))
    return ac.replace(tas=tas, cas=cas, mach=mach, hdg=hdg, vs=vs, ax=ax,
                      swhdgsel=swhdgsel, swaltsel=swaltsel)


def update_groundspeed(ac, windn=None, winde=None):
    """Ground speed/track from heading, TAS and wind (None = calm)."""
    hdgrad = geo.radians(ac.hdg)
    tasnorth = ac.tas * torch.cos(hdgrad)
    taseast = ac.tas * torch.sin(hdgrad)
    if windn is None:
        return ac.replace(gsnorth=tasnorth, gseast=taseast,
                          gs=ac.tas, trk=ac.hdg)
    airborne = ac.alt > 50.0 * aero.ft
    gsnorth = tasnorth + windn * airborne
    gseast = taseast + winde * airborne
    gs = torch.where(airborne, torch.sqrt(gsnorth * gsnorth + gseast * gseast),
                     ac.tas)
    trk = torch.where(airborne,
                      geo.degrees(torch.atan2(gseast, gsnorth)) % 360.0,
                      ac.hdg)
    return ac.replace(gsnorth=gsnorth, gseast=gseast, gs=gs, trk=trk)


def update_position(ac, pilot, simdt):
    """Explicit-Euler position integration on the mean-radius sphere."""
    alt = torch.where(ac.swaltsel, ac.alt + ac.vs * simdt, pilot.alt)
    lat = ac.lat + geo.degrees(simdt * ac.gsnorth / aero.Rearth)
    coslat = torch.cos(geo.radians(lat))
    lon = ac.lon + geo.degrees(simdt * ac.gseast / coslat / aero.Rearth)
    return ac.replace(alt=alt, lat=lat, lon=lon, coslat=coslat)


def update_atmosphere(ac):
    """Refresh p/rho/T at current altitudes."""
    p, rho, temp = aero.vatmos(ac.alt)
    return ac.replace(p=p, rho=rho, temp=temp)
