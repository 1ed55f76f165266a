"""Aircraft kinematics: airspeed/heading/VS dynamics + position integration.

Port of ``bluesky_tpu/core/kinematics.py`` (reference
``Traffic.UpdateAirSpeed / UpdateGroundSpeed / UpdatePosition``).  The
differentiable relaxation of the JAX package is not ported.
"""
import torch

from ..ops import aero, geo


def update_airspeed(ac, pilot, accel, simdt, eps=0.01):
    """TAS/heading/VS dynamics toward the pilot targets."""
    delta_spd = pilot.tas - ac.tas
    need_ax = torch.abs(delta_spd) > aero.kts
    ax = need_ax * torch.sign(delta_spd) * accel
    tas = ac.tas + ax * simdt
    cas = aero.vtas2cas(tas, ac.alt)
    mach = aero.vtas2mach(tas, ac.alt)

    turnrate = geo.degrees(aero.g0 * torch.tan(ac.bank)
                           / torch.clamp_min(tas, eps))
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
