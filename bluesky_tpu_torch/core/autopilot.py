"""FMS / autopilot guidance, vectorized over the aircraft axis.

Port of ``bluesky_tpu/core/autopilot.py``: the dt-gated FMS update
(waypoint switching as a masked gather over the dense ``[N, W]`` route
tables, ComputeVNAV as a ``where`` lattice, continuous guidance) and the
per-step TAS command.  The route tables are read only; route editing is
host-side and comes with the stack port.
"""
import torch

from ..ops import aero, geo, ties
from .state import SimState

STEEPNESS = 3000.0 * aero.ft / (10.0 * aero.nm)
FMS_DT = 1.01  # [s] FMS scheduling interval


def degto180(angle):
    """Wrap angle to (-180, 180]."""
    return (angle + 180.0) % 360.0 - 180.0


def calcturn(tas, bank, wpqdr, next_wpqdr):
    """Turn-anticipation distance and turn radius."""
    turnrad = tas * tas / (ties.maximum(torch.tan(bank), 0.01) * aero.g0)
    turndist = torch.abs(
        turnrad * torch.tan(geo.radians(0.5 * torch.abs(
            degto180(wpqdr % 360.0 - next_wpqdr % 360.0)))))
    return turndist, turnrad


def update_fms(state: SimState) -> SimState:
    """The dt-gated FMS update: waypoint switching + continuous guidance."""
    ac, actwp, ap, route = state.ac, state.actwp, state.ap, state.route
    neg999 = torch.full_like(ac.lat, -999.0)

    qdr, distnm = geo.qdrdist(ac.lat, ac.lon, actwp.lat, actwp.lon)
    dist = distnm * aero.nm

    next_qdr_eff = torch.where(actwp.next_qdr < -900.0, qdr, actwp.next_qdr)
    turndist_r, turnrad = calcturn(ac.tas, ac.bank, qdr, next_qdr_eff)
    turndist_r = actwp.flyby * turndist_r
    turnrad = actwp.flyby * turnrad

    away = torch.abs(degto180(ac.trk % 360.0 - qdr % 360.0)) > 90.0
    incircle = dist < turnrad * 1.01
    circling = away & incircle
    reached = ac.swlnav & ((dist < turndist_r) | circling) & ac.active

    lnavon = route.iactwp + 1 < route.nwp
    iact_new = torch.where(reached & lnavon, route.iactwp + 1, route.iactwp)

    tables = torch.stack([route.wplat, route.wplon, route.wpalt,
                          route.wpspd, route.wpflyby, route.wptoalt,
                          route.wpxtoalt], dim=-1)         # [N, W, 7]
    wmax = route.wplat.shape[1]
    safe = torch.clamp(iact_new, 0, wmax - 1).long()
    g = torch.gather(tables, 1, safe[:, None, None].expand(-1, 1, 7))[:, 0]
    (wplat, wplon, wpalt, wpspd, wpflyby, wptoalt,
     wpxtoalt) = [g[:, i] for i in range(7)]
    have_next = iact_new + 1 < route.nwp
    safe2 = torch.clamp(iact_new + 1, 0, wmax - 1).long()
    g2 = torch.gather(tables[:, :, :2], 1,
                      safe2[:, None, None].expand(-1, 1, 2))[:, 0]
    legqdr, _ = geo.qdrdist(wplat, wplon, g2[:, 0], g2[:, 1])
    next_qdr_new = torch.where(have_next, legqdr, neg999)

    oldspd = actwp.spd
    swlnav = torch.where(reached, ac.swlnav & lnavon, ac.swlnav)
    swvnav = ac.swvnav & swlnav

    new_wplat = torch.where(reached, wplat, actwp.lat)
    new_wplon = torch.where(reached, wplon, actwp.lon)
    new_flyby = torch.where(reached, wpflyby, actwp.flyby)
    new_nextaltco = torch.where(reached & (wpalt >= -0.01), wpalt,
                                actwp.nextaltco)
    new_xtoalt = torch.where(reached, wpxtoalt, actwp.xtoalt)

    spd_valid = (wpspd > -990.0) & swlnav & swvnav
    spd_conv = torch.where(
        ac.abco & (wpspd > 1.0), aero.vcas2mach(wpspd, ac.alt),
        torch.where(ac.belco & (0.0 < wpspd) & (wpspd <= 1.0),
                    aero.vmach2cas(wpspd, ac.alt), wpspd))
    new_wpspd = torch.where(reached, torch.where(spd_valid, spd_conv, neg999),
                            actwp.spd)

    selspd = torch.where(reached & swvnav & (oldspd > 0.0), oldspd, ac.selspd)

    qdr_new, _ = geo.qdrdist(ac.lat, ac.lon, new_wplat, new_wplon)
    qdr = torch.where(reached, qdr_new, qdr)
    local_next_qdr = torch.where(next_qdr_new < -900.0, qdr, next_qdr_new)
    turndist_new, _ = calcturn(ac.tas, ac.bank, qdr, local_next_qdr)
    new_turndist = torch.where(reached, turndist_new, actwp.turndist)
    new_next_qdr = torch.where(reached, next_qdr_new, actwp.next_qdr)

    toalt = wptoalt
    novnav = (toalt < 0.0) | ~swvnav
    descend = ac.alt > toalt + 10.0 * aero.ft
    climb = ac.alt < toalt - 10.0 * aero.ft
    nextaltco_d = torch.minimum(ac.alt, toalt + wpxtoalt * STEEPNESS)
    dist2vs_d = new_turndist + torch.abs(ac.alt - nextaltco_d) / STEEPNESS
    vnav_nextaltco = torch.where(descend, nextaltco_d,
                                 torch.where(climb, toalt, new_nextaltco))
    vnav_dist2vs = torch.where(
        descend, dist2vs_d,
        torch.where(climb, torch.full_like(ac.lat, 99999.0 * aero.nm), neg999))
    vnav_dist2vs = torch.where(novnav, neg999, vnav_dist2vs)
    new_nextaltco = torch.where(reached & ~novnav & (descend | climb),
                                vnav_nextaltco, new_nextaltco)
    dist2vs = torch.where(reached, vnav_dist2vs, ap.dist2vs)

    actwp = actwp.replace(lat=new_wplat, lon=new_wplon, flyby=new_flyby,
                          nextaltco=new_nextaltco, xtoalt=new_xtoalt,
                          spd=new_wpspd, turndist=new_turndist,
                          next_qdr=new_next_qdr)
    route = route.replace(iactwp=iact_new)

    dy = actwp.lat - ac.lat
    dx = (actwp.lon - ac.lon) * ac.coslat
    dist2wp = 60.0 * aero.nm * torch.sqrt(dx * dx + dy * dy)

    startdescent = (dist2wp < dist2vs) | (actwp.nextaltco > ac.alt)
    swvnavvs = swvnav & torch.where(
        swlnav, startdescent, dist <= ties.maximum(actwp.turndist, 185.2))

    t2go2alt = ties.maximum(dist2wp + actwp.xtoalt - actwp.turndist, 0.0) \
        / ties.maximum(ac.gs, 0.5)
    actwp_vs = torch.maximum(STEEPNESS * ac.gs,
                             torch.abs(actwp.nextaltco - ac.alt)
                             / ties.maximum(t2go2alt, 1.0))
    actwp = actwp.replace(vs=actwp_vs)

    vnavvs = torch.where(swvnavvs, actwp_vs, ap.vnavvs)
    selvs_eff = torch.where(torch.abs(ac.selvs) > 0.1, ac.selvs, ac.apvsdef)
    ap_vs = torch.where(swvnavvs, vnavvs, selvs_eff)
    ap_alt = torch.where(swvnavvs, actwp.nextaltco, ac.selalt)
    selalt = torch.where(swvnavvs, actwp.nextaltco, ac.selalt)
    ap_trk = torch.where(swlnav, qdr, ap.trk)

    nexttas = aero.vcasormach2tas(actwp.spd, ac.alt)
    tasdiff = nexttas - ac.tas
    dtspdchg = torch.abs(tasdiff) / ties.maximum(torch.abs(ac.ax), 0.01)
    dxspdchg = (0.5 * torch.sign(tasdiff) * torch.abs(ac.ax) * dtspdchg
                * dtspdchg + ac.tas * dtspdchg)
    usespdcon = (dist2wp < dxspdchg) & (actwp.spd > -990.0) & swvnav
    selspd = torch.where(usespdcon, actwp.spd, selspd)

    ac = ac.replace(swlnav=swlnav, swvnav=swvnav, selspd=selspd,
                    selalt=selalt)
    ap = ap.replace(trk=ap_trk, alt=ap_alt, vs=ap_vs, vnavvs=vnavvs,
                    swvnavvs=swvnavvs, dist2vs=dist2vs)
    return state.replace(ac=ac, actwp=actwp, ap=ap, route=route)


def update_continuous(state: SimState) -> SimState:
    """Per-step TAS command from the selected CAS/Mach."""
    ap_tas = aero.vcasormach2tas(state.ac.selspd, state.ac.alt)
    return state.replace(ap=state.ap.replace(tas=ap_tas))
