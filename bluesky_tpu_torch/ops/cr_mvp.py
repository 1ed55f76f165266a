"""Modified Voltage Potential (MVP) conflict resolution on tensors.

Port of ``bluesky_tpu/ops/cr_mvp.py``: the per-pair displacement
(``pair_contrib_trig`` from the bearing's sin/cos, which the tile bodies
use, and ``pair_contrib_core`` / ``pair_contributions`` on the dense
``[N, N]`` matrices), the dense ``resolve`` with the NORESO/RESOOFF masks
and the FF1-3/LAY1-2 priority rules, the per-aircraft command synthesis
from the accumulated sums (``resolve_from_sums``), and resume-nav: the
keep predicate (``resume_keep_core``) with its flat-earth displacement
(``resume_displacement``) and the dense ``resume_nav`` on ``resopairs``.
The differentiable mode (``wconf``, ``smooth``; ``diff/smooth.py``)
weights the pair sums by sigmoid conflict weights, takes the solve
time as a softmin and the velocity caps as straight-through clips.
"""
from typing import NamedTuple

import torch

from . import geo, ties


class MVPConfig(NamedTuple):
    """Resolver configuration."""
    rpz_m: float          # protected zone radius with margin Rm [m]
    hpz_m: float          # protected zone half-height with margin dhm [m]
    tlookahead: float     # [s]
    swresohoriz: bool = False
    swresospd: bool = False
    swresohdg: bool = False
    swresovert: bool = False
    swprio: bool = False         # priority rules on (PRIORULES)
    priocode: str = "FF1"        # FF1/FF2/FF3/LAY1/LAY2 (MVP.py:235-300)


def pair_contributions(cd, alt, gseast, gsnorth, vs, cfg):
    """Per-pair MVP displacement of all [N, N] pairs of a
    ``cd.ConflictData`` (MVP.py:149-231): (dve, dvn, dvv, tsolv), the
    contribution of pair (i, j) to ownship i; garbage where
    ``cd.swconfl`` is False."""
    return pair_contrib_core(
        cd.qdr, cd.dist, cd.tcpa, cd.tinconf,
        alt[..., None, :] - alt[..., :, None],
        gseast[..., None, :] - gseast[..., :, None],
        gsnorth[..., None, :] - gsnorth[..., :, None],
        vs[..., None, :] - vs[..., :, None], cfg)


def pair_contrib_core(qdr_deg, dist, tcpa, tlos, drel_v, vrel_e, vrel_n,
                      vrel_v, cfg):
    """MVP pair math from the bearing in degrees, with the erratum
    evaluated by a real arcsine, as the JAX dense path passes
    ``jnp.arcsin``."""
    qdr = geo.radians(qdr_deg)
    return pair_contrib_trig(torch.sin(qdr), torch.cos(qdr), dist, tcpa,
                             tlos, drel_v, vrel_e, vrel_n, vrel_v, cfg,
                             arcsin=torch.asin)


def pair_contrib_trig(sin_qdr, cos_qdr, dist, tcpa, tlos,
                      drel_v, vrel_e, vrel_n, vrel_v, cfg, arcsin=None):
    """MVP pair math with the bearing as (sin, cos) (MVP.py:149-231).
    The non-grazing erratum is cos(arcsin r1 - arcsin r2) when
    ``arcsin`` is given (the dense path) and its algebraic identity
    otherwise (the tile bodies); the two round differently.  Returns
    (dve, dvn, dvv, tsolv) of pair (own, intruder)."""
    drel_e = sin_qdr * dist
    drel_n = cos_qdr * dist
    dcpa_e = drel_e + vrel_e * tcpa
    dcpa_n = drel_n + vrel_n * tcpa
    dabsh = torch.sqrt(dcpa_e * dcpa_e + dcpa_n * dcpa_n)
    ih = cfg.rpz_m - dabsh

    headon = dabsh <= 10.0
    safe_dist = ties.maximum(dist, 1e-9)
    dcpa_e = torch.where(headon, drel_n / safe_dist * 10.0, dcpa_e)
    dcpa_n = torch.where(headon, -drel_e / safe_dist * 10.0, dcpa_n)
    dabsh = torch.where(headon, torch.full_like(dabsh, 10.0), dabsh)

    abstcpa = ties.maximum(torch.abs(tcpa), 1e-9)
    dve = (ih * dcpa_e) / (abstcpa * dabsh)
    dvn = (ih * dcpa_n) / (abstcpa * dabsh)

    apply_err = (cfg.rpz_m < dist) & (dabsh < dist)
    # one correctly rounded division, as JAX computes it (a Python float
    # over a tensor would be reciprocal-then-multiply)
    ratio1 = ties.clip(torch.div(torch.full_like(dist, cfg.rpz_m),
                                   safe_dist), -1.0, 1.0)
    ratio2 = ties.clip(dabsh / safe_dist, -1.0, 1.0)
    if arcsin is not None:
        erratum = torch.cos(arcsin(ratio1) - arcsin(ratio2))
    else:
        erratum = (torch.sqrt(torch.clamp_min(1.0 - ratio1 * ratio1, 0.0))
                   * torch.sqrt(torch.clamp_min(1.0 - ratio2 * ratio2, 0.0))
                   + ratio1 * ratio2)
    erratum = torch.where(apply_err, erratum, torch.ones_like(erratum))
    erratum = torch.where(torch.abs(erratum) < 1e-9,
                          torch.full_like(erratum, 1e-9), erratum)
    dve = dve / erratum
    dvn = dvn / erratum

    has_dvs = torch.abs(vrel_v) > 0.0
    hpz = torch.full_like(drel_v, cfg.hpz_m)
    iv = torch.where(has_dvs, hpz, cfg.hpz_m - torch.abs(drel_v))
    tsolv = torch.where(
        has_dvs,
        torch.abs(drel_v / torch.where(has_dvs, vrel_v, torch.ones_like(vrel_v))),
        tlos)
    slow = tsolv > cfg.tlookahead
    tsolv = torch.where(slow, tlos, tsolv)
    iv = torch.where(slow, hpz, iv)
    tsolv_safe = torch.where(torch.abs(tsolv) < 1e-9,
                             torch.full_like(tsolv, 1e-9), tsolv)
    dvv = torch.where(has_dvs, (iv / tsolv_safe) * (-torch.sign(vrel_v)),
                      iv / tsolv_safe)
    return dve, dvn, dvv, tsolv


def _prio_masks(priocode, ci, mixed):
    """The priority rules (MVP.py:235-300) as (apply, vertical apply)
    masks of the directional pair (i, j) from the cruise flags ``ci`` of
    the ownships and ``mixed`` (one of the two cruises): "ownship i
    solves" keeps row i's contribution."""
    if priocode == "FF2":
        # cruiser has priority: the climbing/descending one solves
        apply = torch.where(mixed, ~ci, True)
        return apply, apply
    if priocode == "FF3":
        # climber/descender has priority: the cruiser solves, in mixed
        # pairs horizontally only
        apply = torch.where(mixed, ci, True)
        return apply, apply & ~mixed
    if priocode == "LAY1":
        # all horizontal; the climbing/descending one solves in mixed pairs
        return torch.where(mixed, ~ci, True), torch.zeros_like(mixed)
    if priocode == "LAY2":
        # all horizontal; the cruiser solves in mixed pairs
        return torch.where(mixed, ci, True), torch.zeros_like(mixed)
    raise ValueError(f"Unknown priocode {priocode!r}; expected "
                     "FF1/FF2/FF3/LAY1/LAY2")


def resolve(cd, alt, gseast, gsnorth, vs, trk, gs, selalt, ap_vs, prev_alt,
            vmin, vmax, vsmin, vsmax, cfg, noreso=None, resooff=None,
            wconf=None, smooth=None):
    """Per-aircraft MVP commands from the dense conflict matrices of
    ``cd`` (MVP.py:14-143): nobody avoids a ``noreso`` intruder,
    ``resooff`` aircraft do not resolve, and with ``cfg.swprio`` the
    ``cfg.priocode`` rule masks each pair's contribution.  In the
    differentiable mode ``wconf`` ([N, N] in [0, 1],
    ``smooth.soft_conflict_weight``) replaces the hard ``cd.swconfl``
    mask on the sums, and with ``smooth`` the solve time is a weighted
    softmin and the caps are straight-through.  Returns (newtrk, newgs,
    newvs, newalt, asase, asasn)."""
    dve_p, dvn_p, dvv_p, tsolv_p = pair_contributions(
        cd, alt, gseast, gsnorth, vs, cfg)
    mask = cd.swconfl
    if noreso is not None:
        mask = mask & ~noreso[..., None, :]
    if wconf is not None:
        # masked and diagonal pairs carry the detect's 1e9 offsets, which
        # drive their weight to exactly 0, and their pair fields are
        # finite, so 0 * x stays 0
        maskf = wconf if noreso is None \
            else wconf * (~noreso[..., None, :]).to(dve_p.dtype)
    else:
        maskf = mask.to(dve_p.dtype)
    vmaskf = maskf
    if cfg.swprio and cfg.priocode != "FF1":
        cruise = torch.abs(vs) < 0.1        # cruising: |vs| < 0.1 m/s
        ci = cruise[..., :, None]
        apply, vapply = _prio_masks(cfg.priocode, ci,
                                    ci ^ cruise[..., None, :])
        maskf = maskf * apply
        vmaskf = maskf * vapply

    sum_dve = (dve_p * maskf).sum(-1)
    sum_dvn = (dvn_p * maskf).sum(-1)
    sum_dvv = (dvv_p * vmaskf).sum(-1)
    if wconf is not None and smooth is not None:
        from ..diff.smooth import softmin_weighted
        tsolv = softmin_weighted(tsolv_p, maskf,
                                 smooth.temp_min * cfg.tlookahead)
    else:
        tsolv = torch.where(mask, tsolv_p,
                            torch.full_like(tsolv_p, 1e9)).amin(-1)
    return resolve_from_sums(
        sum_dve, sum_dvn, sum_dvv, tsolv, alt, gseast, gsnorth, vs, trk, gs,
        selalt, ap_vs, prev_alt, vmin, vmax, vsmin, vsmax, cfg,
        resooff=resooff, smooth=smooth)


def resolve_from_sums(sum_dve, sum_dvn, sum_dvv, tsolv,
                      alt, gseast, gsnorth, vs, trk, gs,
                      selalt, ap_vs, prev_alt,
                      vmin, vmax, vsmin, vsmax, cfg, resooff=None,
                      smooth=None):
    """Per-aircraft command synthesis from accumulated pair contributions
    (MVP.py:67-143); with ``smooth`` (``ste_caps``) the velocity caps
    are straight-through clips.  Returns (newtrk, newgs, newvs, newalt,
    asase, asasn)."""
    dve = -sum_dve
    dvn = -sum_dvn
    dvv = -0.5 * sum_dvv
    if resooff is not None:
        keep = ~resooff
        zero = torch.zeros_like(dve)
        dve = torch.where(keep, dve, zero)
        dvn = torch.where(keep, dvn, zero)
        dvv = torch.where(keep, dvv, zero)

    newv_e = dve + gseast
    newv_n = dvn + gsnorth
    newv_v = dvv + vs
    has_reso = dve * dve + dvn * dvn > 0.0

    full_trk = geo.degrees(torch.atan2(newv_e, newv_n)) % 360.0
    full_gs = torch.sqrt(newv_e * newv_e + newv_n * newv_n)
    if cfg.swresohoriz:
        if cfg.swresospd and not cfg.swresohdg:
            newtrk, newgs_, newvs = trk, full_gs, vs
        elif cfg.swresohdg and not cfg.swresospd:
            newtrk, newgs_, newvs = full_trk, gs, vs
        else:
            newtrk, newgs_, newvs = full_trk, full_gs, vs
    elif cfg.swresovert:
        newtrk, newgs_, newvs = trk, gs, newv_v
    else:
        newtrk, newgs_, newvs = full_trk, full_gs, newv_v

    if smooth is not None and smooth.ste_caps:
        from ..diff.smooth import ste_clip
        newgs_ = ste_clip(newgs_, vmin, vmax)
        newvs = ste_clip(newvs, vsmin, vsmax)
    else:
        newgs_ = ties.clip(newgs_, vmin, vmax)
        newvs = ties.clip(newvs, vsmin, vsmax)

    zero = torch.zeros_like(newgs_)
    asase = torch.where(has_reso, newgs_ * torch.sin(geo.radians(newtrk)), zero)
    asasn = torch.where(has_reso, newgs_ * torch.cos(geo.radians(newtrk)), zero)

    signdvs = torch.sign(newvs - ap_vs * torch.sign(selalt - alt))
    signalt = torch.sign(prev_alt - selalt)
    newalt = torch.where((signdvs == 0) | (signdvs == signalt), prev_alt, selalt)
    altcond = (tsolv < cfg.tlookahead) & (torch.abs(dvv) > 0.0)
    newalt = torch.where(altcond, newvs * tsolv + alt, newalt)
    if cfg.swresohoriz:
        newalt = selalt
    return newtrk, newgs_, newvs, newalt, asase, asasn


def resume_displacement(lat_own, lon_own, lat_other, lon_other):
    """Flat-earth east/north displacement [m] of the resume predicates
    (reference asas.py:426-432), for the gathered [N, K] partner table."""
    dist_e = geo.REARTH * (geo.radians(lon_other - lon_own)
                           * torch.cos(0.5 * geo.radians(lat_other + lat_own)))
    dist_n = geo.REARTH * geo.radians(lat_other - lat_own)
    return dist_e, dist_n


def resume_keep_core(dist_e, dist_n, vrel_e, vrel_n, trk_i, trk_j,
                     alive, rpz, rpz_m):
    """Resume-nav keep predicate (reference asas.py:426-455): a pair
    stays engaged while not past CPA, in horizontal LoS, or in a
    near-parallel "bouncing" encounter."""
    past_cpa = dist_e * vrel_e + dist_n * vrel_n > 0.0
    hdist = torch.sqrt(dist_e * dist_e + dist_n * dist_n)
    hor_los = hdist < rpz
    is_bouncing = (torch.abs(trk_i - trk_j) < 30.0) & (hdist < rpz_m)
    return (~past_cpa | hor_los | is_bouncing) & alive


def resume_nav(resopairs, lat, lon, gseast, gsnorth, trk, active_ac, rpz,
               rpz_m):
    """Resume-nav on the dense pair matrix (reference asas.py:409-471): a
    pair of ``resopairs`` [N, N] stays engaged while the keep predicate
    holds.  Returns (new_resopairs, asas_active), ``asas_active[i]`` =
    any pair (i, j) still engaged.  (The JAX function's unused ``swlos``
    argument is dropped.)"""
    dist_e, dist_n = resume_displacement(lat[..., :, None], lon[..., :, None],
                                         lat[..., None, :], lon[..., None, :])
    vrel_e = gseast[..., None, :] - gseast[..., :, None]
    vrel_n = gsnorth[..., None, :] - gsnorth[..., :, None]
    alive = active_ac[..., :, None] & active_ac[..., None, :]
    keep = resume_keep_core(dist_e, dist_n, vrel_e, vrel_n, trk[..., :, None],
                            trk[..., None, :], alive, rpz, rpz_m)
    new_resopairs = resopairs & keep
    return new_resopairs, new_resopairs.any(-1)
