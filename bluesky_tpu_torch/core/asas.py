"""Airborne Separation Assurance: one CD&R interval on tensors.

Port of the single-device MVP part of ``bluesky_tpu/core/asas.py``:
``AsasConfig``; the dense interval (``update``: ``cd.detect`` on
``[N, N]`` matrices, ``cr_mvp.resolve``, the ``resopairs`` bookkeeping
and ``cr_mvp.resume_nav``) and ``detect_only``; the spatial-sort refresh
(``refresh_spatial_sort``: the stripe sort of ``impl="sparse"``, the
Morton order of ``impl="pallas"`` and ``"lax"``); and the blockwise
interval (``update_tiled``): detect, resolve with MVP from the
accumulated pair sums, then resume-nav, in-kernel on the sorted-space
table ``partners_s`` (sparse) or on the host side of the caller-space
table ``partners`` (pallas, lax).  The EBY, SWARM and SSD resolvers and
the spatial/tiles shard modes are not ported yet (``ROADMAP.md`` §A) and
raise ``NotImplementedError``.
"""
from typing import NamedTuple

import torch

from ..ops import aero, cd as cdops, cd_pallas, cd_sched, cd_tiled, cr_mvp
from .state import SimState


class AsasConfig(NamedTuple):
    """ASAS settings (reference asas.py:10-13 defaults + setters), the
    fields and field order of the JAX ``AsasConfig``.  ``mar`` and
    ``sort_every`` are read by nothing the port runs yet (the stack and
    the simulation loop, ROADMAP.md A6)."""
    swasas: bool = True
    dtasas: float = 1.0          # [s] CD&R interval
    dtlookahead: float = 300.0   # [s]
    rpz: float = 5.0 * aero.nm   # [m] protected-zone radius (R)
    hpz: float = 1000.0 * aero.ft  # [m] protected-zone half-height (dh)
    mar: float = 1.05            # resolution margin factor
    resofach: float = 1.05       # horizontal resolution factor (Rm = R*fac)
    resofacv: float = 1.05       # vertical resolution factor
    swresohoriz: bool = False
    swresospd: bool = False
    swresohdg: bool = False
    swresovert: bool = False
    reso_on: bool = True         # conflict resolution enabled (RESO MVP/OFF)
    reso_method: str = "MVP"     # only MVP is ported
    swprio: bool = False         # PRIORULES on/off
    priocode: str = "FF1"        # FF1/FF2/FF3/LAY1/LAY2
    sort_every: int = 30         # CD intervals between Morton re-sorts
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


#: resolvers of the JAX package the port does not run yet
_RESOLVERS_NOT_PORTED = ("EBY", "SWARM", "SSD")


def require_resolver(cfg: AsasConfig):
    """Raise for a resolver the port cannot run: EBY, SWARM and SSD are
    not ported yet (``NotImplementedError``), any other name is unknown
    (``ValueError``)."""
    if not cfg.reso_on:
        return
    method = cfg.reso_method.upper()
    if method in _RESOLVERS_NOT_PORTED:
        raise NotImplementedError(
            f"resolver {cfg.reso_method!r} is not ported yet: only MVP is "
            "(ROADMAP.md A3)")
    if method != "MVP":
        raise ValueError(
            f"Unknown AsasConfig.reso_method {cfg.reso_method!r}; "
            "expected MVP, EBY, SWARM or SSD.")


def _mvp_config(cfg: AsasConfig, prio=False) -> cr_mvp.MVPConfig:
    """The MVP settings of ``cfg``; the priority rules act on the dense
    path only, as in the JAX package."""
    extra = dict(swprio=cfg.swprio, priocode=cfg.priocode) if prio else {}
    return cr_mvp.MVPConfig(
        rpz_m=cfg.rpz_m, hpz_m=cfg.hpz_m, tlookahead=cfg.dtlookahead,
        swresohoriz=cfg.swresohoriz, swresospd=cfg.swresospd,
        swresohdg=cfg.swresohdg, swresovert=cfg.swresovert, **extra)


def _apply_commands(asas, upd, cmds):
    """Store the resolution commands ``(trk, tas, vs, alt, asase,
    asasn)`` on the rows ``upd``; the other rows keep the previous
    resolution state."""
    names = ("trk", "tas", "vs", "alt", "asase", "asasn")
    return asas.replace(**{
        k: torch.where(upd, new.to(getattr(asas, k).dtype), getattr(asas, k))
        for k, new in zip(names, cmds)})


def update(state: SimState, cfg: AsasConfig):
    """One dense ASAS interval (asas.py:473-504): ``cd.detect`` on the
    [N, N] pair space, MVP on the conflict matrix, the pair bookkeeping
    ``resopairs |= swconfl`` and resume-nav.  Needs the [N, N]
    ``resopairs`` of ``make_state(pair_matrix=True)``.  Returns
    ``(state, cd)``."""
    require_resolver(cfg)
    ac, asas = state.ac, state.asas
    cd = cdops.detect(ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                      ac.active, cfg.rpz, cfg.hpz, cfg.dtlookahead)
    if cfg.reso_on:
        cmds = cr_mvp.resolve(
            cd, ac.alt, ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs,
            ac.selalt, state.ap.vs, asas.alt, cfg.vmin, cfg.vmax,
            cfg.vsmin, cfg.vsmax, _mvp_config(cfg, prio=True),
            noreso=asas.noreso, resooff=asas.resooff)
        asas = _apply_commands(asas, cd.inconf, cmds)
    resopairs, active = cr_mvp.resume_nav(
        asas.resopairs | cd.swconfl, ac.lat, ac.lon, ac.gseast, ac.gsnorth,
        ac.trk, ac.active, cfg.rpz, cfg.rpz * cfg.resofach)
    asas = asas.replace(
        resopairs=resopairs, active=active & cfg.reso_on, inconf=cd.inconf,
        tcpamax=cd.tcpamax, nconf_cur=cd.swconfl.sum(dtype=torch.int32),
        nlos_cur=cd.swlos.sum(dtype=torch.int32))
    return state.replace(asas=asas), cd


def detect_only(state: SimState, cfg: AsasConfig):
    """CD without resolution (the RESO OFF path): the flags and counts
    only.  Returns ``(state, cd)``."""
    ac = state.ac
    cd = cdops.detect(ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                      ac.active, cfg.rpz, cfg.hpz, cfg.dtlookahead)
    asas = state.asas.replace(
        inconf=cd.inconf, tcpamax=cd.tcpamax,
        nconf_cur=cd.swconfl.sum(dtype=torch.int32),
        nlos_cur=cd.swlos.sum(dtype=torch.int32))
    return state.replace(asas=asas), cd


def impl_for_backend(cd_backend: str) -> str:
    """SimConfig.cd_backend -> update_tiled/refresh_spatial_sort impl."""
    return {"pallas": "pallas", "sparse": "sparse"}.get(cd_backend, "lax")


def _require_impl(impl):
    if impl not in ("sparse", "pallas", "lax"):
        raise ValueError(f"Unknown CD&R impl {impl!r}; expected 'lax', "
                         "'pallas' or 'sparse'")


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
    them; for ``impl="pallas"`` and ``"lax"`` it holds the Morton
    permutation (sorted position -> caller slot) and ``partners`` stays
    in caller space."""
    _require_impl(impl)
    ac = state.ac
    if impl != "sparse":
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
    """One blockwise ASAS interval: detect, resolve with MVP from the pair
    sums, resume-nav.  ``impl="sparse"``: the segment-scheduled kernels
    with resume-nav in-kernel on the sorted-space ``partners_s``, with
    ``sort_perm`` the stripe destinations.  ``impl="pallas"``
    (``cd_pallas.detect_resolve_pallas``) and ``impl="lax"``
    (``cd_tiled.detect_resolve_tiled``): in the Morton order
    ``sort_perm`` (sorted position -> caller slot), then resume-nav on
    the host side of the caller-space ``partners``.  Returns
    ``(state, rd)``."""
    _require_impl(impl)
    require_resolver(cfg)
    ac, asas = state.ac, state.asas
    mvpcfg = _mvp_config(cfg)
    cols = (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, asas.noreso, cfg.rpz, cfg.hpz,
            cfg.dtlookahead, mvpcfg)
    if impl == "pallas":
        rd = cd_pallas.detect_resolve_pallas(*cols, block=block,
                                             perm=asas.sort_perm)
    elif impl == "lax":
        rd = cd_tiled.detect_resolve_tiled(
            *cols, block=block, k_partners=asas.partners.shape[1],
            perm=asas.sort_perm)
    else:
        block = min(block, 256)
        n_tot = cd_sched.padded_size(ac.lat.shape[0], block)
        rd, partners_s, act_new = cd_sched.detect_resolve_sched(
            *cols, partners=asas.partners_s[:n_tot],
            resume_rpz_m=cfg.rpz * cfg.resofach, block=block,
            perm=asas.sort_perm)
    if cfg.reso_on:
        asas = _apply_commands(asas, rd.inconf, cr_mvp.resolve_from_sums(
            rd.sum_dve, rd.sum_dvn, rd.sum_dvv, rd.tsolv,
            ac.alt, ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs,
            ac.selalt, state.ap.vs, asas.alt,
            cfg.vmin, cfg.vmax, cfg.vsmin, cfg.vsmax, mvpcfg,
            resooff=asas.resooff))
    if impl != "sparse":
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
