"""Modified Voltage Potential (MVP) conflict resolution on tensors.

Port of the large-N half of ``bluesky_tpu/ops/cr_mvp.py``: the per-pair
displacement from the bearing's sin/cos (``pair_contrib_trig``, which
the plain tile body uses), the per-aircraft command synthesis from the
accumulated sums (``resolve_from_sums``) and the resume-nav keep
predicate (``resume_keep_core``) with its flat-earth displacement
(``resume_displacement``).  The priority rules act on the dense pair
matrices only and come with the dense backend.
"""
from typing import NamedTuple

import torch

from . import geo


class MVPConfig(NamedTuple):
    """Resolver configuration."""
    rpz_m: float          # protected zone radius with margin Rm [m]
    hpz_m: float          # protected zone half-height with margin dhm [m]
    tlookahead: float     # [s]
    swresohoriz: bool = False
    swresospd: bool = False
    swresohdg: bool = False
    swresovert: bool = False


def pair_contrib_trig(sin_qdr, cos_qdr, dist, tcpa, tlos,
                      drel_v, vrel_e, vrel_n, vrel_v, cfg):
    """MVP pair math with the bearing as (sin, cos) (MVP.py:149-231);
    the non-grazing erratum cos(asin r1 - asin r2) by its algebraic
    identity.  Returns (dve, dvn, dvv, tsolv) of pair (own, intruder)."""
    drel_e = sin_qdr * dist
    drel_n = cos_qdr * dist
    dcpa_e = drel_e + vrel_e * tcpa
    dcpa_n = drel_n + vrel_n * tcpa
    dabsh = torch.sqrt(dcpa_e * dcpa_e + dcpa_n * dcpa_n)
    ih = cfg.rpz_m - dabsh

    headon = dabsh <= 10.0
    safe_dist = torch.clamp_min(dist, 1e-9)
    dcpa_e = torch.where(headon, drel_n / safe_dist * 10.0, dcpa_e)
    dcpa_n = torch.where(headon, -drel_e / safe_dist * 10.0, dcpa_n)
    dabsh = torch.where(headon, torch.full_like(dabsh, 10.0), dabsh)

    abstcpa = torch.clamp_min(torch.abs(tcpa), 1e-9)
    dve = (ih * dcpa_e) / (abstcpa * dabsh)
    dvn = (ih * dcpa_n) / (abstcpa * dabsh)

    apply_err = (cfg.rpz_m < dist) & (dabsh < dist)
    ratio1 = torch.clamp(cfg.rpz_m / safe_dist, -1.0, 1.0)
    ratio2 = torch.clamp(dabsh / safe_dist, -1.0, 1.0)
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


def resolve_from_sums(sum_dve, sum_dvn, sum_dvv, tsolv,
                      alt, gseast, gsnorth, vs, trk, gs,
                      selalt, ap_vs, prev_alt,
                      vmin, vmax, vsmin, vsmax, cfg, resooff=None):
    """Per-aircraft command synthesis from accumulated pair contributions
    (MVP.py:67-143).  Returns (newtrk, newgs, newvs, newalt, asase,
    asasn)."""
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

    newgs_ = torch.clamp(newgs_, vmin, vmax)
    newvs = torch.clamp(newvs, vsmin, vsmax)

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
