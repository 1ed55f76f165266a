"""Airborne Separation Assurance: the sparse and pallas CD&R intervals on
tensors.

Port of the single-device MVP part of ``bluesky_tpu/core/asas.py``:
``AsasConfig``, the spatial-sort refresh (``refresh_spatial_sort``: the
stripe sort of ``impl="sparse"``, the Morton order of ``impl="pallas"``)
and one ASAS interval (``update_tiled``): detect, resolve with MVP from
the accumulated pair sums, then resume-nav, in-kernel on the
sorted-space table ``partners_s`` (sparse) or on the host side of the
caller-space table ``partners`` (pallas).  The dense and tiled backends,
the EBY, SWARM and SSD resolvers and the spatial/tiles shard modes are
not ported yet (``ROADMAP.md`` §A) and raise ``NotImplementedError``.
"""
from typing import NamedTuple

import torch

from ..ops import aero, cd_pallas, cd_sched, cd_tiled, cr_mvp
from .state import SimState


class AsasConfig(NamedTuple):
    """ASAS settings (reference asas.py:10-13 defaults + setters): the
    fields the sparse MVP interval reads.  The priority and re-sort
    settings come with the slices that read them."""
    swasas: bool = True
    dtasas: float = 1.0          # [s] CD&R interval
    dtlookahead: float = 300.0   # [s]
    rpz: float = 5.0 * aero.nm   # [m] protected-zone radius (R)
    hpz: float = 1000.0 * aero.ft  # [m] protected-zone half-height (dh)
    resofach: float = 1.05       # horizontal resolution factor (Rm = R*fac)
    resofacv: float = 1.05       # vertical resolution factor
    swresohoriz: bool = False
    swresospd: bool = False
    swresohdg: bool = False
    swresovert: bool = False
    reso_on: bool = True         # conflict resolution enabled (RESO MVP/OFF)
    reso_method: str = "MVP"     # only MVP is ported
    vmin: float = 100.0 * aero.kts   # [m/s] resolution speed caps
    vmax: float = 180.0 * aero.kts
    vsmin: float = -3000.0 * aero.fpm
    vsmax: float = 3000.0 * aero.fpm

    @property
    def rpz_m(self):
        return self.rpz * self.resofach

    @property
    def hpz_m(self):
        return self.hpz * self.resofacv


def impl_for_backend(cd_backend: str) -> str:
    """SimConfig.cd_backend -> update_tiled/refresh_spatial_sort impl."""
    return {"pallas": "pallas", "sparse": "sparse"}.get(cd_backend, "lax")


def _require_ported(impl):
    if impl not in ("sparse", "pallas"):
        raise NotImplementedError(
            f"CD&R impl {impl!r} is not ported yet: only the sparse and "
            "pallas backends are (ROADMAP.md A2 dense/tiled)")


def _sparse_sort_refresh(lat, lon, gs, active, old_perm, partners_s, *,
                         block, tlookahead, rpz):
    """Stripe sort plus the remap of the sorted-space partner table from
    the old layout to the new one (old slot -> caller slot -> new slot)."""
    thresh = cd_sched.reach_threshold_m(gs, active, tlookahead, rpz)
    dest = cd_sched.stripe_sort_dest(lat, lon, gs, active, thresh, block, 32)
    n = lat.shape[0]
    n_tot = cd_sched.padded_size(n, block)
    inv_old = cd_sched.slot_inverse(old_perm, n, n_tot)
    pv = partners_s[:n_tot]
    neg = torch.full_like(pv, -1)
    caller_vals = torch.where(
        pv >= 0, inv_old[torch.clamp(pv, 0, n_tot).long()], neg)
    new_vals = torch.where(
        caller_vals >= 0, dest[torch.clamp(caller_vals, 0, n - 1).long()],
        neg)
    per_caller = new_vals[torch.clamp(old_perm, 0, n_tot - 1).long(), :]
    new_partners = torch.full_like(partners_s, -1)
    new_partners[dest.long()] = per_caller
    return dest, new_partners


def refresh_spatial_sort(state: SimState, cfg: AsasConfig,
                         block: int = 512, impl: str = "lax") -> SimState:
    """Recompute the cached spatial sort ``asas.sort_perm`` (host-called
    at chunk boundaries; any staleness is exact, it only loosens the
    blocks).  As in the JAX package the field means two things: for
    ``impl="sparse"`` it holds the stripe destinations (caller slot ->
    sorted slot) and the sorted-space ``partners_s`` is remapped with
    them; for ``impl="pallas"`` it holds the Morton permutation (sorted
    position -> caller slot) and ``partners`` stays in caller space."""
    _require_ported(impl)
    ac = state.ac
    if impl == "pallas":
        perm = cd_tiled.spatial_permutation(ac.lat, ac.lon, ac.active)
        return state.replace(asas=state.asas.replace(
            sort_perm=perm.to(torch.int32)))
    dest, partners_s = _sparse_sort_refresh(
        ac.lat, ac.lon, ac.gs, ac.active, state.asas.sort_perm,
        state.asas.partners_s, block=min(block, 256),
        tlookahead=float(cfg.dtlookahead), rpz=float(cfg.rpz))
    return state.replace(asas=state.asas.replace(sort_perm=dest,
                                                 partners_s=partners_s))


def update_tiled(state: SimState, cfg: AsasConfig, block: int = 512,
                 impl: str = "lax"):
    """One ASAS interval: detect, resolve with MVP from the pair sums,
    resume-nav.  ``impl="sparse"``: the segment-scheduled kernels with
    resume-nav in-kernel on the sorted-space ``partners_s``, with
    ``sort_perm`` the stripe destinations.  ``impl="pallas"``:
    ``cd_pallas.detect_resolve_pallas`` in the Morton order
    ``sort_perm`` (sorted position -> caller slot), then resume-nav on
    the host side of the caller-space ``partners``.  Returns
    ``(state, rd)``."""
    _require_ported(impl)
    if cfg.reso_on and cfg.reso_method.upper() != "MVP":
        raise NotImplementedError(
            f"resolver {cfg.reso_method!r} is not ported yet: only MVP is "
            "(ROADMAP.md A3)")
    ac, asas = state.ac, state.asas
    mvpcfg = cr_mvp.MVPConfig(
        rpz_m=cfg.rpz_m, hpz_m=cfg.hpz_m, tlookahead=cfg.dtlookahead,
        swresohoriz=cfg.swresohoriz, swresospd=cfg.swresospd,
        swresohdg=cfg.swresohdg, swresovert=cfg.swresovert)
    if impl == "pallas":
        rd = cd_pallas.detect_resolve_pallas(
            ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, asas.noreso, cfg.rpz, cfg.hpz,
            cfg.dtlookahead, mvpcfg, block=block, perm=asas.sort_perm)
    else:
        block = min(block, 256)
        n_tot = cd_sched.padded_size(ac.lat.shape[0], block)
        rd, partners_s, act_new = cd_sched.detect_resolve_sched(
            ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, asas.noreso, cfg.rpz, cfg.hpz,
            cfg.dtlookahead, mvpcfg, partners=asas.partners_s[:n_tot],
            resume_rpz_m=cfg.rpz * cfg.resofach, block=block,
            perm=asas.sort_perm)
    if cfg.reso_on:
        newtrk, newgs, newvs, newalt, asase, asasn = \
            cr_mvp.resolve_from_sums(
                rd.sum_dve, rd.sum_dvn, rd.sum_dvv, rd.tsolv,
                ac.alt, ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs,
                ac.selalt, state.ap.vs, asas.alt,
                cfg.vmin, cfg.vmax, cfg.vsmin, cfg.vsmax, mvpcfg,
                resooff=asas.resooff)
        upd = rd.inconf
        w = lambda new, old: torch.where(upd, new.to(old.dtype), old)
        asas = asas.replace(
            trk=w(newtrk, asas.trk), tas=w(newgs, asas.tas),
            vs=w(newvs, asas.vs), alt=w(newalt, asas.alt),
            asase=w(asase, asas.asase), asasn=w(asasn, asas.asasn))
    if impl == "pallas":
        # Resume-nav on the caller-space table (asas.py:1124-1144): prune
        # the old partners, merge in this interval's fresh conflicts,
        # prune the merged table.
        prune = lambda tbl: cd_tiled.partner_keep(
            tbl, ac.lat, ac.lon, ac.gseast, ac.gsnorth, ac.trk, ac.active,
            cfg.rpz, cfg.rpz * cfg.resofach)
        new_idx = cd_tiled.topk_partners(rd, asas.partners.shape[1])
        merged = cd_tiled.merge_partners(new_idx, asas.partners,
                                         prune(asas.partners))
        partners = torch.where(prune(merged), merged,
                               torch.full_like(merged, -1))
        asas = asas.replace(partners=partners)
        act_new = (partners >= 0).any(1)
    else:
        spad = asas.partners_s.shape[0] - partners_s.shape[0]
        if spad > 0:
            partners_s = torch.cat([partners_s, partners_s.new_full(
                (spad, partners_s.shape[1]), -1)])
        asas = asas.replace(partners_s=partners_s)
    asas = asas.replace(
        active=act_new & cfg.reso_on,
        inconf=rd.inconf,
        tcpamax=rd.tcpamax.to(asas.tcpamax.dtype),
        nconf_cur=rd.nconf,
        nlos_cur=rd.nlos)
    return state.replace(asas=asas), rd
