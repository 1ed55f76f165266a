"""Airborne Separation Assurance: one CD&R interval on tensors.

Port of the single-device part of ``bluesky_tpu/core/asas.py``:
``AsasConfig``; the dense interval (``update``: ``cd.detect`` on
``[N, N]`` matrices, one of the resolvers MVP, EBY, SWARM or SSD, the
``resopairs`` bookkeeping and ``cr_mvp.resume_nav``) and
``detect_only``; the spatial-sort refresh (``refresh_spatial_sort``:
the stripe sort of ``impl="sparse"``, also as ``inscan_sparse_refresh``
for the chunk runner, the Morton order of ``impl="pallas"`` and
``"lax"``); and the blockwise interval
(``update_tiled``): detect with the resolver's pair sums (MVP, Eby, or
MVP plus the Swarm neighbour sums), resolve from the sums (SSD from the
partner table), then resume-nav, in-kernel on the sorted-space table
``partners_s`` (sparse) or on the host side of the caller-space table
``partners`` (pallas, lax).  The shard modes (``update_tiled(mesh=...,
shard_mode=...)``) have their refreshes here: ``refresh_spatial_shard``
and ``refresh_tile_shard`` (stripe or tile sort, caller-slot
re-bucketing onto the shards, partner remap and the halo-contract check;
an overloaded stripe or tile, or reach past the halo or the pinned
budgets, raises ``RuntimeError``), and their in-chunk forms
``inscan_spatial_refresh`` and ``inscan_tile_refresh``, which skip a
violating refresh and report it in a guard word instead.
"""
import numpy as np
from typing import NamedTuple

import torch

from ..ops import aero, cd as cdops, cd_pallas, cd_sched, cd_tiled, cr_eby, \
    cr_mvp, cr_ssd, cr_swarm, geo
from .state import SimState
from ..obs.trace import get_recorder, sync


class AsasConfig(NamedTuple):
    """ASAS settings (reference asas.py:10-13 defaults + setters), the
    fields and field order of the JAX ``AsasConfig``.  ``sort_every``
    sets the simulation loop's refresh cadence (``simulation/sim.py``);
    ``mar`` is read by nothing the port runs yet."""
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
    reso_method: str = "MVP"     # MVP / EBY / SWARM / SSD
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


#: the resolvers of ``AsasConfig.reso_method``
RESOLVERS = ("MVP", "EBY", "SWARM", "SSD")


def require_resolver(cfg: AsasConfig):
    """Raise ``ValueError`` for an unknown ``reso_method``."""
    if cfg.reso_on and cfg.reso_method.upper() not in RESOLVERS:
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


def _with_velocity(newtrk, newgs, newvs, newalt):
    """A resolver's (trk, tas, vs, alt) with the east/north components of
    (trk, tas)."""
    trkrad = geo.radians(newtrk)
    return (newtrk, newgs, newvs, newalt, newgs * torch.sin(trkrad),
            newgs * torch.cos(trkrad))


def _ssd_config(cfg: AsasConfig) -> cr_ssd.SSDConfig:
    """PRIORULES RS1..RS9 select the SSD rule set (SSD.py:429-558); any
    other priority code (the MVP FF*/LAY* family) means RS1."""
    code = cfg.priocode.upper()
    rs = code if cfg.swprio and code.startswith("RS") else "RS1"
    return cr_ssd.SSDConfig(rpz_m=cfg.rpz_m, tlookahead=cfg.dtlookahead,
                            priocode=rs)


def _swarm_inputs(state: SimState):
    """The Swarm blend's autopilot commands: the AP track, ``selspd``
    resolved to CAS as the autopilot does (the reference blends the raw
    ``selspd``, a unit bug the JAX package fixes), ``selvs``."""
    ac = state.ac
    _, selcas, _ = aero.vcasormach(ac.selspd, ac.alt)
    return state.ap.trk, selcas, ac.selvs


def update(state: SimState, cfg: AsasConfig, smooth=None):
    """One dense ASAS interval (asas.py:473-504): ``cd.detect`` on the
    [N, N] pair space, the resolver on the conflict matrix, the pair
    bookkeeping ``resopairs |= swconfl`` and resume-nav.  Needs the
    [N, N] ``resopairs`` of ``make_state(pair_matrix=True)``.  A stacked
    state (``step.stack_worlds``: [W, N] columns, [W, N, N]
    ``resopairs``) runs every world at once, the pair matrices
    [W, N, N] by broadcasting over the leading axis.

    ``smooth`` (a ``diff.smooth.SmoothConfig``; None on the serving
    path) relaxes the MVP resolver for the differentiable rollout:
    sigmoid pair weights on the contribution sums
    (``soft_conflict_weight``), a softmin solve time and
    straight-through caps.  The per-aircraft engagement (``inconf``,
    ``active``) stays hard; the gradient rides the weights.  Another
    resolver raises ``ValueError``.  Returns ``(state, cd)``."""
    require_resolver(cfg)
    ac, asas = state.ac, state.asas
    cd = cdops.detect(ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                      ac.active, cfg.rpz, cfg.hpz, cfg.dtlookahead)
    method = cfg.reso_method.upper()
    if smooth is not None and cfg.reso_on and method != "MVP":
        raise ValueError(
            "differentiable mode (SimConfig.smooth) relaxes the MVP "
            f"resolver only, not {cfg.reso_method!r}: use RESO MVP "
            "(or RESO OFF) for gradient workloads.")
    wconf = None
    if smooth is not None and cfg.reso_on:
        from ..diff.smooth import soft_conflict_weight
        wconf = soft_conflict_weight(cd, cfg.rpz, cfg.dtlookahead, smooth)
    swarm_on = cfg.reso_on and method == "SWARM"
    any_conf = cd.swconfl.any(-1).any(-1)      # per world on [W, N, N]
    if cfg.reso_on:
        upd = cd.inconf
        if method in ("MVP", "SWARM"):
            cmds = cr_mvp.resolve(
                cd, ac.alt, ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs,
                ac.selalt, state.ap.vs, asas.alt, cfg.vmin, cfg.vmax,
                cfg.vsmin, cfg.vsmax, _mvp_config(cfg, prio=True),
                noreso=asas.noreso, resooff=asas.resooff, wconf=wconf,
                smooth=smooth)
        if method == "EBY":
            cmds = _with_velocity(*cr_eby.resolve(
                cd, ac.alt, ac.vs, ac.trk, ac.tas, cfg.rpz_m, cfg.vmin,
                cfg.vmax))
        elif method == "SWARM":
            # the MVP output blended with alignment and centering; the
            # CA gate is the previous interval's active flags
            # (Swarm.py:68-73).  The whole swarm takes the commands once
            # any conflict exists (asas.py:487, Swarm.py:101-102).
            cmds = _with_velocity(*cr_swarm.resolve(
                cd, ac.lat, ac.lon, ac.alt, ac.trk, ac.gs, ac.cas, ac.vs,
                ac.gseast, ac.gsnorth, ac.active, cmds[0], cmds[1],
                cmds[2], asas.active, *_swarm_inputs(state), cfg.vmin,
                cfg.vmax))
            upd = ac.active & any_conf[..., None]
        elif method == "SSD":
            # a horizontal method (SSD.py:99-104): vs and alt stay
            newtrk, newgs = cr_ssd.resolve(
                cd, ac.lat, ac.lon, ac.alt, ac.trk, ac.gs, ac.vs,
                ac.gseast, ac.gsnorth, ac.active, cfg.vmin, cfg.vmax,
                _ssd_config(cfg), hdg=ac.hdg, ap_trk=state.ap.trk,
                ap_tas=state.ap.tas)
            cmds = _with_velocity(newtrk, newgs, asas.vs, asas.alt)
        asas = _apply_commands(asas, upd, cmds)
    resopairs, active = cr_mvp.resume_nav(
        asas.resopairs | cd.swconfl, ac.lat, ac.lon, ac.gseast, ac.gsnorth,
        ac.trk, ac.active, cfg.rpz, cfg.rpz * cfg.resofach)
    if swarm_on:
        # the whole swarm follows ASAS once a conflict triggered a resolve
        active = torch.where(any_conf[..., None], ac.active, active)
    asas = asas.replace(
        resopairs=resopairs, active=active & cfg.reso_on, inconf=cd.inconf,
        tcpamax=cd.tcpamax,
        nconf_cur=cd.swconfl.sum((-2, -1), dtype=torch.int32),
        nlos_cur=cd.swlos.sum((-2, -1), dtype=torch.int32))
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
    the old layout to the new one (old slot -> caller slot -> new slot);
    each world on its own for columns with a leading world axis."""
    thresh = cd_sched.reach_threshold_m(gs, active, tlookahead, rpz)
    dest = cd_sched.stripe_sort_dest(lat, lon, gs, active, thresh, block, 32)
    n = lat.shape[-1]
    n_tot = cd_sched.padded_size(n, block)
    inv_old = cd_sched.slot_inverse(old_perm, n, n_tot)
    pv = partners_s[..., :n_tot, :]
    neg = torch.full_like(pv, -1)
    caller_vals = torch.where(
        pv >= 0, cd_tiled.take_ids(inv_old, torch.clamp(pv, 0, n_tot).long()),
        neg)
    new_vals = torch.where(
        caller_vals >= 0,
        cd_tiled.take_ids(dest, torch.clamp(caller_vals, 0, n - 1).long()),
        neg)
    per_caller = cd_tiled.take_rows(
        new_vals, torch.clamp(old_perm, 0, n_tot - 1).long())
    new_partners = torch.full_like(partners_s, -1)
    rows = dest.long()[..., None].expand(*dest.shape, partners_s.shape[-1])
    return dest, new_partners.scatter_(-2, rows, per_caller)


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
    if impl == "sparse":
        return inscan_sparse_refresh(state, cfg, block=block)
    ac = state.ac
    perm = cd_tiled.spatial_permutation(ac.lat, ac.lon, ac.active)
    return state.replace(asas=state.asas.replace(
        sort_perm=perm.to(torch.int32)))


def inscan_sparse_refresh(state: SimState, cfg: AsasConfig,
                          block: int = 256) -> SimState:
    """The sparse sort refresh as a state -> state function: the
    ``refresh_spatial_sort`` sparse branch, which the chunk runner calls
    between steps when ``SimConfig.inscan_refresh`` is due
    (``core/step.py``)."""
    ac = state.ac
    dest, partners_s = _sparse_sort_refresh(
        ac.lat, ac.lon, ac.gs, ac.active, state.asas.sort_perm,
        state.asas.partners_s, block=min(block, 256),
        tlookahead=float(cfg.dtlookahead), rpz=float(cfg.rpz))
    return state.replace(asas=state.asas.replace(sort_perm=dest,
                                                 partners_s=partners_s))


def _rebucket_callers(active, dest0, dev, n, n_tot, ndev, C):
    """Caller-slot re-bucketing of the stripe and tile refreshes (a full
    [n] bijection): shard d's caller rows ``[d * C, (d + 1) * C)`` get
    exactly the active aircraft whose sorted slots d owns, packed in
    sorted order; inactive rows fill the shards' tails.  Returns
    ``(newslot [n], src [n], counts [ndev])``; ``counts <= C`` is the
    occupancy contract the caller checks."""
    device = active.device
    aidx = torch.arange(n, dtype=torch.int64, device=device)
    key = torch.where(active, dest0.long(), n_tot + aidx)
    order = torch.argsort(key, stable=True)
    act_o = active[order]
    dev_o = dev[order].long()
    oh = (dev_o[:, None] == torch.arange(ndev, device=device)[None, :]) \
        & act_o[:, None]
    counts = oh.sum(0)
    rank_o = ((torch.cumsum(oh.long(), 0) - 1) * oh).sum(1)
    slot_act_o = dev_o * C + rank_o
    free = (aidx % C) >= counts[torch.clamp_max(aidx // C, ndev - 1)]
    free_slots = torch.sort(torch.where(free, aidx,
                                        torch.full_like(aidx, n))).values
    n_act = active.sum()
    inact_rank = torch.clamp(aidx - n_act, 0, n - 1)
    newslot_o = torch.where(act_o, slot_act_o, free_slots[inact_rank])
    newslot = torch.zeros(n, dtype=torch.int64, device=device) \
        .scatter_(0, order, newslot_o)
    # an overloaded shard's slots run past n: dropped, as JAX drops them
    # (the caller refuses that layout)
    src = torch.zeros(n + 1, dtype=torch.int64, device=device) \
        .scatter_(0, torch.clamp(newslot, 0, n), aidx)[:n]
    return newslot.to(torch.int32), src.to(torch.int32), \
        counts.to(torch.int32)


def _remap_partners_sorted(old_perm, partners_s, active, dest0, dest_sent,
                           n, n_tot):
    """Remap the sorted-space partner table from the old layout to the
    new one (old slot -> old caller -> new slot), for the stripe and tile
    refreshes; rows and partners that are inactive drop out."""
    inv_old = cd_sched.slot_inverse(old_perm, n, n_tot)
    pv = partners_s[:n_tot]
    neg = torch.full_like(pv, -1)
    caller_vals = torch.where(
        pv >= 0, inv_old[torch.clamp(pv, 0, n_tot).long()], neg)
    cv = torch.clamp(caller_vals, 0, n - 1).long()
    new_vals = torch.where((caller_vals >= 0) & active[cv],
                           dest0[cv].to(pv.dtype), neg)
    row_ok = (old_perm < n_tot) & active
    per_caller = torch.where(
        row_ok[:, None],
        new_vals[torch.clamp(old_perm, 0, n_tot - 1).long()],
        torch.full_like(new_vals[:n], -1))
    out = torch.full((n_tot + 1, pv.shape[1]), -1, dtype=torch.int32,
                     device=pv.device)
    out[torch.clamp(dest_sent, 0, n_tot).long()] = per_caller \
        .to(torch.int32)
    return out[:n_tot]


def _swarm_reach(cfg: AsasConfig) -> float:
    """The interval's horizontal reach floor: the Swarm neighbourhood
    under RESO SWARM (``cd_sched`` widens the schedule so), else 0."""
    if cfg.reso_on and cfg.reso_method.upper() == "SWARM":
        return float(cr_swarm.R_SWARM)
    return 0.0


def _margin_reach(lat, lon, gs, active, dest_sent, nb, n_tot, block, cfg):
    """The drift-margin widened block reachability of a new layout (no
    vertical gating): what the halo and budget checks validate.  Returns
    ``(reach_m [nb, nb], gsmax)``."""
    plat, plon, pgs, pact = cd_sched.scatter_padded(
        [lat, lon, gs, active.to(lat.dtype)], dest_sent, n_tot,
        sentinel=True)
    summ = cd_tiled.block_summaries(plat, plon, pgs, pact > 0.5, nb, block)
    gsmax = torch.where(active, gs, torch.zeros_like(gs)).max()
    margin_s = float(cfg.sort_every * cfg.dtasas)
    reach_m = cd_tiled.reachability_from_summaries(
        summ, summ, float(cfg.rpz), float(cfg.dtlookahead),
        min_reach_m=_swarm_reach(cfg), margin_m=2.0 * gsmax * margin_s)
    return reach_m, gsmax


def _spatial_shard_refresh(lat, lon, gs, active, old_perm, partners_s, *,
                           block, ndev, extra, halo, cfg):
    """The spatial refresh's device part: stripe sort (padding spread),
    caller-slot re-bucketing, partner remap and the halo check.

    Returns ``(newslot, src, sort_perm_new, partners_new, stats)``:
    old caller -> new caller slot, new -> old (the gather of every
    [n]-leading leaf), new caller -> sorted slot (the sentinel ``n_tot``
    on inactive rows), the remapped table and ``(counts [ndev], halo_ok,
    halo_need, gsmax)`` (per-shard occupancy, whether the ``halo``-block
    window covers every drift-margin widened reachable pair, and the
    widest halo needed)."""
    n = lat.shape[0]
    nb = -(-n // block) + extra
    n_tot = nb * block
    nb_l = nb // ndev
    S = nb_l * block
    C = n // ndev
    thresh = cd_sched.reach_threshold_m(gs, active, float(cfg.dtlookahead),
                                        float(cfg.rpz))
    dest0 = cd_sched.stripe_sort_dest(lat, lon, gs, active, thresh, block,
                                      extra, spread_pad=True)
    dev = torch.clamp_max(dest0 // S, ndev - 1)
    newslot, src, counts = _rebucket_callers(active, dest0, dev, n, n_tot,
                                             ndev, C)
    dest_sent = torch.where(active, dest0, torch.full_like(dest0, n_tot))
    sort_perm_new = dest_sent[src.long()]
    partners_new = _remap_partners_sorted(old_perm, partners_s, active,
                                          dest0, dest_sent, n, n_tot)
    reach_m, gsmax = _margin_reach(lat, lon, gs, active, dest_sent, nb,
                                   n_tot, block, cfg)
    bi = torch.arange(nb, device=lat.device)
    d_i = bi // nb_l
    lo = d_i * nb_l - halo
    hi = (d_i + 1) * nb_l + halo
    outside = (bi[None, :] < lo[:, None]) | (bi[None, :] >= hi[:, None])
    halo_ok = ~(reach_m & outside).any()
    need = torch.clamp_min(torch.maximum(
        (d_i * nb_l)[:, None] - bi[None, :],
        bi[None, :] - ((d_i + 1) * nb_l)[:, None] + 1), 0)
    halo_need = torch.where(reach_m, need, torch.zeros_like(need)).max()
    return newslot, src, sort_perm_new, partners_new, \
        (counts, halo_ok, halo_need, gsmax)


def _permute_state(state: SimState, srcidx, newslot, sort_perm,
                   partners_new):
    """The state after a re-bucketing: every [n]-leading tensor gathered
    by ``srcidx`` (new -> old caller slot), the caller-space partner ids
    moved with their slots, the new sort and sorted-space table."""
    from .state import _tree_map
    n = state.nmax
    src = srcidx.long()

    def permute(name, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 \
                and leaf.shape[0] == n:
            return leaf[src]
        return leaf
    new = _tree_map(permute, state)
    p = new.asas.partners
    p = torch.where(p >= 0, newslot[torch.clamp(p, 0, n - 1).long()]
                    .to(p.dtype), p)
    return new.replace(asas=new.asas.replace(
        sort_perm=sort_perm.to(torch.int32), partners_s=partners_new,
        partners=p))


def _pad_table(partners_new, rows):
    """The sorted-space table padded with empty rows to ``rows``."""
    spad = rows - partners_new.shape[0]
    if spad <= 0:
        return partners_new
    return torch.cat([partners_new, partners_new.new_full(
        (spad, partners_new.shape[1]), -1)])


def refresh_spatial_shard(state: SimState, cfg: AsasConfig, ndev: int,
                          block: int = 256, halo_blocks: int = 0):
    """Spatial-mode chunk-edge refresh: stripe sort, caller-slot
    re-bucketing, partner remap and the halo-coverage check, then the
    state permuted.  Returns ``(state, newslot, info)``: ``newslot`` the
    old -> new caller slot map (numpy; the caller remaps its host tables,
    ``Traffic.apply_slot_permutation``), ``info`` the per-shard occupancy,
    the halo width pinned and needed and the layout.

    Raises ``RuntimeError`` when a shard's stripes hold more aircraft than
    its caller rows, or reach crosses more than the halo window even
    after the drift margin; the caller falls back to ``replicate``.
    ``halo_blocks`` 0 is AUTO: check against the widest window, then pin
    1.25x the need (at least one shard's blocks).  Each blocking read of
    the device is a ``sync`` span."""
    ac = state.ac
    n = ac.lat.shape[0]
    block = min(block, 256)
    extra, nb, nb_l, n_tot = cd_sched.spatial_layout(n, block, ndev)
    if state.asas.partners_s.shape[0] < n_tot:
        raise RuntimeError(
            f"spatial refresh: partners_s holds "
            f"{state.asas.partners_s.shape[0]} rows < n_tot={n_tot} — "
            "enable spatial mode first (it resizes the sorted tables)")
    halo_max = (ndev - 1) * nb_l
    auto = not halo_blocks
    halo = halo_max if auto else min(int(halo_blocks), halo_max)
    newslot, srcidx, sort_perm, partners_new, stats = \
        _spatial_shard_refresh(
            ac.lat, ac.lon, ac.gs, ac.active, state.asas.sort_perm,
            state.asas.partners_s[:n_tot], block=block, ndev=int(ndev),
            extra=extra, halo=halo, cfg=cfg)
    counts, halo_ok, halo_need, gsmax = stats
    with sync("spatial_refresh.check"):
        counts = counts.cpu().numpy()
        halo_need, halo_ok = int(halo_need), bool(halo_ok)
        gsmax = float(gsmax)
    if auto:
        halo = min(max(nb_l, int(np.ceil(1.25 * halo_need))), halo_max)
    C = n // ndev
    if counts.max() > C:
        raise RuntimeError(
            f"spatial refresh: stripe occupancy overflow — device "
            f"{int(counts.argmax())} owns {int(counts.max())} aircraft "
            f"> caller-shard capacity {C} (nmax/{ndev}). Raise nmax or "
            "use SHARD REPLICATE for this geometry.")
    if not halo_ok:
        raise RuntimeError(
            f"spatial refresh: halo coverage violated — reachability "
            f"(drift-margin widened) needs {halo_need} halo blocks "
            f"> {halo} available per side. Use SHARD REPLICATE or fewer "
            "devices for this geometry.")
    partners_new = _pad_table(partners_new, state.asas.partners_s.shape[0])
    new_state = _permute_state(state, srcidx, newslot, sort_perm,
                               partners_new)
    info = dict(counts=counts, occupancy=float(counts.max() / max(C, 1)),
                halo_blocks=halo, halo_need=halo_need, gsmax=gsmax,
                nb=nb, nb_local=nb_l, n_tot=n_tot, extra_blocks=extra,
                halo_rows=2 * halo * block * ndev)
    with sync("spatial_refresh.newslot"):
        newslot = newslot.cpu().numpy()
    return new_state, newslot, info


def _tile_shard_refresh(lat, lon, gs, active, old_perm, partners_s, *,
                        block, extra, tiles, budgets, cfg):
    """The tile refresh's device part: tile-major sort, caller-slot
    re-bucketing, partner remap and the corner-halo contract check: every
    drift-margin widened reachable block pair stays inside the canonical
    edge and corner neighbourhood (``cd_sched.tile_offsets``) and, with
    ``budgets``, each offset's per-receiver import need fits its budget.
    ``stats`` is ``(counts [ndev], halo_ok, budget_ok, needs [n_offs],
    gsmax)``."""
    n = lat.shape[0]
    nb = -(-n // block) + extra
    n_tot = nb * block
    tR, tC = int(tiles[0]), int(tiles[1])
    ndev = tR * tC
    nb_t = nb // ndev
    S = nb_t * block
    C = n // ndev
    thresh = cd_sched.reach_threshold_m(gs, active, float(cfg.dtlookahead),
                                        float(cfg.rpz))
    dest0 = cd_sched.tile_sort_dest(lat, lon, gs, active, thresh, block,
                                    extra, (tR, tC))
    dev = torch.clamp_max(dest0 // S, ndev - 1)
    newslot, src, counts = _rebucket_callers(active, dest0, dev, n, n_tot,
                                             ndev, C)
    dest_sent = torch.where(active, dest0, torch.full_like(dest0, n_tot))
    sort_perm_new = dest_sent[src.long()]
    partners_new = _remap_partners_sorted(old_perm, partners_s, active,
                                          dest0, dest_sent, n, n_tot)
    reach_m, gsmax = _margin_reach(lat, lon, gs, active, dest_sent, nb,
                                   n_tot, block, cfg)
    # column need per receiving tile: any of its rows reaching column b
    cn_t = reach_m.reshape(ndev, nb_t, nb).any(1).reshape(ndev, ndev, nb_t)
    treach = cn_t.any(2)                                    # [recv, src]
    offs = cd_sched.tile_offsets((tR, tC))
    allowed = np.eye(ndev, dtype=bool)
    for off in offs:
        for u, v in cd_sched._offset_pairs((tR, tC), off):
            allowed[v, u] = True               # v imports from sender u
    halo_ok = ~(treach & ~torch.as_tensor(allowed, device=lat.device)).any()
    needs = []
    for off in offs:
        uv = np.full(ndev, -1, np.int64)
        for u, v in cd_sched._offset_pairs((tR, tC), off):
            uv[v] = u
        cnt = cn_t[torch.arange(ndev, device=lat.device),
                   torch.as_tensor(np.maximum(uv, 0), device=lat.device)] \
            .sum(-1, dtype=torch.int32)
        needs.append(torch.where(torch.as_tensor(uv >= 0, device=lat.device),
                                 cnt, torch.zeros_like(cnt)).max())
    needs = torch.stack(needs) if needs else \
        torch.zeros(0, dtype=torch.int32, device=lat.device)
    budget_ok = (needs <= torch.as_tensor(budgets, dtype=needs.dtype,
                                          device=needs.device)).all() \
        if budgets else torch.ones((), dtype=torch.bool, device=lat.device)
    return newslot, src, sort_perm_new, partners_new, \
        (counts, halo_ok, budget_ok, needs, gsmax)


def refresh_tile_shard(state: SimState, cfg: AsasConfig, tiles,
                       block: int = 256, budgets=()):
    """Tiles-mode chunk-edge refresh: tile-major sort, caller-slot
    re-bucketing, partner remap and the corner-halo contract check, then
    the state permuted; the lat x lon counterpart of
    ``refresh_spatial_shard`` (same returns).  ``budgets`` () is AUTO:
    pin each canonical offset's budget at 1.25x its measured need (at
    least 4 blocks, at most the tile).

    Raises ``RuntimeError`` on a tile holding more aircraft than its
    caller rows, on reach escaping the edge and corner neighbourhood, or
    on a pinned budget short of the measured need; the caller falls back
    (tiles -> spatial -> replicate).  Each blocking read of the device
    is a ``sync`` span."""
    ac = state.ac
    n = ac.lat.shape[0]
    block = min(block, 256)
    tR, tC = int(tiles[0]), int(tiles[1])
    ndev = tR * tC
    extra, nb, nb_t, n_tot = cd_sched.spatial_layout(n, block, ndev)
    if state.asas.partners_s.shape[0] < n_tot:
        raise RuntimeError(
            f"tile refresh: partners_s holds "
            f"{state.asas.partners_s.shape[0]} rows < n_tot={n_tot} — "
            "enable tiles mode first (it resizes the sorted tables)")
    auto = not budgets
    budgets = tuple(int(b) for b in budgets) if budgets else ()
    newslot, srcidx, sort_perm, partners_new, stats = _tile_shard_refresh(
        ac.lat, ac.lon, ac.gs, ac.active, state.asas.sort_perm,
        state.asas.partners_s[:n_tot], block=block, extra=extra,
        tiles=(tR, tC), budgets=budgets, cfg=cfg)
    counts, halo_ok, budget_ok, needs, gsmax = stats
    with sync("tile_refresh.check"):
        counts, needs = counts.cpu().numpy(), needs.cpu().numpy()
        halo_ok, budget_ok = bool(halo_ok), bool(budget_ok)
        gsmax = float(gsmax)
    C = n // ndev
    if counts.max() > C:
        t_bad = int(counts.argmax())
        raise RuntimeError(
            f"tile refresh: tile occupancy overflow — tile "
            f"({t_bad // tC},{t_bad % tC}) owns {int(counts.max())} "
            f"aircraft > caller-shard capacity {C} (nmax/{ndev}). Raise "
            "nmax, use a different tile shape, or SHARD "
            "SPATIAL/REPLICATE for this geometry.")
    if not halo_ok:
        raise RuntimeError(
            f"tile refresh: corner-halo contract violated — "
            f"(drift-margin widened) reachability escapes the "
            f"edge+corner neighbourhood of the {tR}x{tC} tile mesh. "
            "Use SHARD SPATIAL/REPLICATE or fewer tiles for this "
            "geometry.")
    if not budget_ok:
        raise RuntimeError(
            f"tile refresh: halo slab budget exceeded — measured "
            f"per-offset import need {needs.tolist()} > pinned budgets "
            f"{list(budgets)}. Re-run SHARD TILE {tR}x{tC} to re-pin, "
            "or SHARD SPATIAL/REPLICATE for this geometry.")
    if auto:
        budgets = tuple(int(min(max(4, -(-int(nd) * 5 // 4)), nb_t))
                        for nd in needs)
    partners_new = _pad_table(partners_new, state.asas.partners_s.shape[0])
    new_state = _permute_state(state, srcidx, newslot, sort_perm,
                               partners_new)
    offs = cd_sched.tile_offsets((tR, tC))
    info = dict(counts=counts, occupancy=float(counts.max() / max(C, 1)),
                tile_shape=(tR, tC), offsets=offs, budgets=budgets,
                needs=needs.tolist(), gsmax=gsmax, nb=nb,
                nb_local=nb_t, n_tot=n_tot, extra_blocks=extra,
                halo_rows=int(sum(budgets)) * block * ndev)
    with sync("tile_refresh.newslot"):
        newslot = newslot.cpu().numpy()
    return new_state, newslot, info


def _inscan_layout(state: SimState, block: int, what: str):
    """``(nb, extra)`` of the layout the sorted-space table was sized to
    (SHARD sized it to the shard-divisible padded layout)."""
    n = state.ac.lat.shape[0]
    n_tot = state.asas.partners_s.shape[0]
    nb0 = -(-n // block)
    if n_tot % block or n_tot // block <= nb0:
        raise ValueError(
            f"in-scan {what} refresh needs partners_s sized to the padded "
            f"layout (got {n_tot} rows for n={n}, block={block}) — enable "
            f"{what} mode via Simulation.set_shard first")
    nb = n_tot // block
    return nb, nb - nb0


def _inscan_apply(state, ok, srcidx, newslot, sort_perm, partners_new):
    """The in-chunk refresh's outcome, selected on the device (``ok`` a
    0-d bool tensor, nothing read back): the permuted state and its
    bijection when the contract held, else the state as it was and the
    identity."""
    from .state import _tree_map
    new = _permute_state(state, srcidx, newslot, sort_perm, partners_new)
    sel = lambda name, a, b: torch.where(ok, a, b) \
        if isinstance(a, torch.Tensor) and a is not b else a
    ident = torch.arange(state.nmax, dtype=torch.int32, device=state.device)
    return _tree_map(sel, new, state), torch.where(ok, newslot, ident)


def inscan_spatial_refresh(state: SimState, cfg: AsasConfig, ndev: int,
                           block: int = 256, halo_blocks: int = 0):
    """The spatial refresh as the chunk runner calls it between steps:
    ``refresh_spatial_shard``'s device part and the state permutation,
    with the ``RuntimeError`` replaced by a guard word.  Returns
    ``(state, newslot, guard)``: ``guard`` bit 1 a stripe occupancy
    overflow, bit 2 a halo-coverage violation; a violating refresh is
    skipped (the old layout stays, ``newslot`` the identity), and the
    host trips the fallback to replicate at the chunk edge.  ``newslot``
    and ``guard`` (0-d int32) are device tensors: nothing is read
    back."""
    block = min(block, 256)
    nb, extra = _inscan_layout(state, block, "spatial")
    nb_l = nb // ndev
    halo_max = (ndev - 1) * nb_l
    halo = halo_max if not halo_blocks else min(int(halo_blocks), halo_max)
    ac = state.ac
    newslot, srcidx, sort_perm, partners_new, stats = \
        _spatial_shard_refresh(
            ac.lat, ac.lon, ac.gs, ac.active, state.asas.sort_perm,
            state.asas.partners_s, block=block, ndev=int(ndev),
            extra=extra, halo=halo, cfg=cfg)
    counts, halo_ok, _need, _gsmax = stats
    overflow = counts.max() > state.nmax // ndev
    guard = overflow.to(torch.int32) | (~halo_ok).to(torch.int32) * 2
    state, newslot = _inscan_apply(state, halo_ok & ~overflow, srcidx,
                                   newslot, sort_perm, partners_new)
    return state, newslot, guard


def inscan_tile_refresh(state: SimState, cfg: AsasConfig, tiles,
                        block: int = 256, budgets=()):
    """The tile refresh as the chunk runner calls it (the tiles analogue
    of ``inscan_spatial_refresh``): ``guard`` bit 2 a corner-halo or
    budget violation, bit 4 a tile occupancy overflow."""
    block = min(block, 256)
    nb, extra = _inscan_layout(state, block, "tile")
    tR, tC = int(tiles[0]), int(tiles[1])
    ac = state.ac
    newslot, srcidx, sort_perm, partners_new, stats = _tile_shard_refresh(
        ac.lat, ac.lon, ac.gs, ac.active, state.asas.sort_perm,
        state.asas.partners_s, block=block, extra=extra, tiles=(tR, tC),
        budgets=tuple(int(b) for b in budgets) if budgets else (), cfg=cfg)
    counts, halo_ok, budget_ok, _needs, _gsmax = stats
    overflow = counts.max() > state.nmax // (tR * tC)
    contract_ok = halo_ok & budget_ok
    guard = overflow.to(torch.int32) * 4 | (~contract_ok).to(torch.int32) * 2
    state, newslot = _inscan_apply(state, contract_ok & ~overflow, srcidx,
                                   newslot, sort_perm, partners_new)
    return state, newslot, guard


def spatial_table_size(n, block=256, ndev=1):
    """Rows of the sorted-space partner table in the spatial and tiles
    modes: the shard-divisible padded layout exactly."""
    return cd_sched.spatial_layout(n, block, ndev)[3]


def _global_ids(t, size):
    """World-local ids ``t`` [W, m, K] (-1 empty) as ids of the W * m
    rows of the flattened worlds: world w's id i becomes ``w * size +
    i``."""
    off = torch.arange(t.shape[0], device=t.device, dtype=t.dtype) * size
    g = torch.where(t >= 0, t + off.reshape(-1, *[1] * (t.ndim - 1)), t)
    return g.reshape(-1, *t.shape[2:])


def _local_ids(t, nworlds, size):
    """Inverse of ``_global_ids``: [W * m, K] global ids -> [W, m, K]."""
    t = t.reshape(nworlds, -1, *t.shape[1:])
    off = torch.arange(nworlds, device=t.device, dtype=t.dtype) * size
    return torch.where(t >= 0, t - off.reshape(-1, *[1] * (t.ndim - 1)), t)


def update_tiled(state: SimState, cfg: AsasConfig, block: int = 512,
                 impl: str = "lax", mesh=None, mesh_axis: str = "ac",
                 shard_mode: str = "replicate", halo_blocks: int = 0,
                 tile_shape=None, tile_budgets=()):
    """One blockwise ASAS interval: detect with the resolver's pair sums,
    resolve from the sums, resume-nav.  ``impl="sparse"``: the
    segment-scheduled kernels with resume-nav in-kernel on the
    sorted-space ``partners_s``, with ``sort_perm`` the stripe
    destinations.  ``impl="pallas"`` (``cd_pallas.detect_resolve_pallas``)
    and ``impl="lax"`` (``cd_tiled.detect_resolve_tiled``): in the Morton
    order ``sort_perm`` (sorted position -> caller slot), then resume-nav
    on the host side of the caller-space ``partners``.

    The resolver picks the kernels' form (JAX ``asas.py:936-1156``): MVP
    and SSD run the MVP sums (SSD then resolves from the partner table),
    EBY its own pair sums on TAS velocities, SWARM the MVP sums plus the
    seven neighbour sums (MVP first, then the blend).  Nothing here reads
    a value back to the host.  Returns ``(state, rd)``.

    ``mesh`` (``parallel/sharding.py``) and the shard arguments pass to
    the sparse interval (``cd_sched.detect_resolve_sched``: replicate,
    spatial or tiles) and, for the replicate row split, to the pallas
    one; the spatial and tiles modes key the padded layout off
    ``partners_s``, which SHARD sized to the shard-divisible layout.

    A stacked state (``step.stack_worlds``) runs every world.  Sparse and
    pallas detect all worlds in one pass, each kernel launched once for
    the stack, and the resolvers then run per aircraft on the W * N
    aircraft, partner ids made global for the gathers.  Tiled loops over
    the worlds: its eager row loop is to be redesigned (ROADMAP A11)."""
    with get_recorder().span("asas.interval", cat="asas", device=True,
                             impl=impl):
        return _update_tiled(state, cfg, block, impl, mesh, mesh_axis,
                             shard_mode, halo_blocks, tile_shape,
                             tile_budgets)


def _update_tiled(state, cfg, block, impl, mesh, mesh_axis, shard_mode,
                  halo_blocks, tile_shape, tile_budgets):
    """``update_tiled``'s interval, inside its span."""
    _require_impl(impl)
    require_resolver(cfg)
    from .state import (flatten_worlds, is_stacked, stack_worlds,
                        unflatten_worlds, unstack_worlds)
    worlds = is_stacked(state)
    if worlds and impl == "lax":
        outs = [_update_tiled(sw, cfg, block, impl, None, "ac",
                              "replicate", 0, None, ())
                for sw in unstack_worlds(state)]
        return (stack_worlds([o[0] for o in outs]),
                stack_worlds([o[1] for o in outs]))
    rec = get_recorder()
    ac, asas = state.ac, state.asas
    mvpcfg = _mvp_config(cfg)
    reso_m = cfg.reso_method.upper()
    kern_reso = {"EBY": "eby", "SWARM": "swarm"}.get(reso_m, "mvp") \
        if cfg.reso_on else "mvp"
    extra = {"eby": {"tas": ac.tas}, "swarm": {"cas": ac.cas}}.get(kern_reso)
    cols = (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, asas.noreso, cfg.rpz, cfg.hpz,
            cfg.dtlookahead, mvpcfg)
    k = asas.partners.shape[-1]
    n = ac.lat.shape[-1]
    if impl == "pallas":
        out = cd_pallas.detect_resolve_pallas(
            *cols, block=block, k_partners=k, perm=asas.sort_perm,
            extra_cols=extra, reso=kern_reso, mesh=mesh,
            mesh_axis=mesh_axis)
    elif impl == "lax":
        out = cd_tiled.detect_resolve_tiled(
            *cols, block=block, k_partners=k, perm=asas.sort_perm,
            extra_cols=extra, reso=kern_reso)
    else:
        block = min(block, 256)
        extra_eff = 32
        if shard_mode in ("spatial", "tiles"):
            n_tot = asas.partners_s.shape[-2]
            nb0 = -(-n // block)
            if n_tot % block or n_tot // block <= nb0:
                raise ValueError(
                    f"{shard_mode} mode needs partners_s sized to the "
                    f"padded layout (got {n_tot} rows for n={n}, "
                    f"block={block}) — enable it via "
                    "Simulation.set_shard/SHARD SPATIAL|TILE")
            extra_eff = n_tot // block - nb0
        else:
            n_tot = cd_sched.padded_size(n, block)
        out = cd_sched.detect_resolve_sched(
            *cols, partners=asas.partners_s[..., :n_tot, :],
            resume_rpz_m=cfg.rpz * cfg.resofach, block=block,
            extra_blocks=extra_eff, perm=asas.sort_perm,
            tas=ac.tas if kern_reso == "eby" else None,
            cas=ac.cas if kern_reso == "swarm" else None, reso=kern_reso,
            mesh=mesh, mesh_axis=mesh_axis, shard_mode=shard_mode,
            halo_blocks=halo_blocks, tile_shape=tile_shape,
            tile_budgets=tile_budgets)
    if kern_reso == "swarm":
        *out, swarm_sums = out
    if impl == "sparse":
        rd, partners_s, act_new = out
    else:
        rd = out[0] if kern_reso == "swarm" else out
    rd_out = rd

    stacked = state
    if worlds:
        # the resolvers on the W * N aircraft of the flattened worlds,
        # with the partner tables in global ids
        nw = ac.lat.shape[0]
        state = flatten_worlds(state)
        flat = lambda a: a.reshape(-1, *a.shape[2:])
        state = state.replace(asas=state.asas.replace(
            partners=_global_ids(stacked.asas.partners, n)))
        rd = rd._replace(**{f: flat(getattr(rd, f)) for f in
                            ("inconf", "tcpamax", "sum_dve", "sum_dvn",
                             "sum_dvv", "tsolv", "topk_tin")},
                         topk_idx=(_global_ids(rd.topk_idx, n)
                                   if impl == "pallas" else
                                   flat(rd.topk_idx)))
        if kern_reso == "swarm":
            swarm_sums = tuple(flat(a) for a in swarm_sums)
        if impl == "sparse":
            act_new = flat(act_new)
        nconf = rd.nconf[:, None].expand(-1, n).reshape(-1)
    else:
        nconf = rd.nconf
    ac, asas = state.ac, state.asas

    with rec.span("cr.resolve", cat="asas", device=True):
        if kern_reso == "swarm":
            # the MVP avoidance from the MVP sums, then the blend with the
            # neighbour sums; the CA gate is the previous active flags
            m_trk, m_gs, m_vs, *_ = cr_mvp.resolve_from_sums(
                rd.sum_dve, rd.sum_dvn, rd.sum_dvv, rd.tsolv,
                ac.alt, ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs,
                ac.selalt, state.ap.vs, asas.alt,
                cfg.vmin, cfg.vmax, cfg.vsmin, cfg.vsmax, mvpcfg,
                resooff=asas.resooff)
            asas = _apply_commands(
                asas, ac.active & (nconf > 0),
                _with_velocity(*cr_swarm.resolve_from_sums(
                    *swarm_sums, ac.alt, ac.trk, ac.cas, ac.vs, ac.gseast,
                    ac.gsnorth, ac.active, m_trk, m_gs, m_vs, asas.active,
                    *_swarm_inputs(state), cfg.vmin, cfg.vmax)))
        elif kern_reso == "eby":
            asas = _apply_commands(asas, rd.inconf, _with_velocity(
                *cr_eby.resolve_from_sums(
                    rd.sum_dve, rd.sum_dvn, rd.sum_dvv, ac.alt, ac.vs, ac.trk,
                    ac.tas, cfg.vmin, cfg.vmax)))
        elif cfg.reso_on and reso_m == "MVP":
            asas = _apply_commands(asas, rd.inconf, cr_mvp.resolve_from_sums(
                rd.sum_dve, rd.sum_dvn, rd.sum_dvv, rd.tsolv,
                ac.alt, ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs,
                ac.selalt, state.ap.vs, asas.alt,
                cfg.vmin, cfg.vmax, cfg.vsmin, cfg.vsmax, mvpcfg,
                resooff=asas.resooff))

    def ssd_resolve(cur, ptable):
        """SSD from the caller-space [N, K] partner table
        (``cr_ssd.resolve_from_partners``), horizontal only."""
        newtrk, newgs = cr_ssd.resolve_from_partners(
            ptable, rd.inconf, ac.lat, ac.lon, ac.alt, ac.trk, ac.gs,
            ac.vs, ac.gseast, ac.gsnorth, ac.active, cfg.vmin, cfg.vmax,
            _ssd_config(cfg), hdg=ac.hdg, ap_trk=state.ap.trk,
            ap_tas=state.ap.tas)
        return _apply_commands(cur, rd.inconf, _with_velocity(
            newtrk, newgs, cur.vs, cur.alt))

    with rec.span("asas.partners", cat="asas", device=True):
        ssd_on = cfg.reso_on and reso_m == "SSD"
        if impl != "sparse":
            # Resume-nav on the caller-space table (asas.py:1124-1144): prune
            # the old partners, merge in this interval's fresh conflicts,
            # prune the merged table.
            prune = lambda tbl: cd_tiled.partner_keep(
                tbl, ac.lat, ac.lon, ac.gseast, ac.gsnorth, ac.trk, ac.active,
                cfg.rpz, cfg.rpz * cfg.resofach)
            new_idx = cd_tiled.topk_partners(rd, k)
            merged = cd_tiled.merge_partners(new_idx, asas.partners,
                                             prune(asas.partners))
            partners = torch.where(prune(merged), merged,
                                   torch.full_like(merged, -1))
            if ssd_on:
                asas = ssd_resolve(asas, partners)
            asas = asas.replace(partners=partners)
            act_new = (partners >= 0).any(1)
        else:
            if ssd_on:
                # the in-kernel merged table is sorted-space
                ptable = cd_sched.partners_to_caller(
                    stacked.asas.sort_perm, partners_s, n,
                    partners_s.shape[-2])
                asas = ssd_resolve(asas, _global_ids(ptable, n) if worlds
                                   else ptable)
            spad = stacked.asas.partners_s.shape[-2] - partners_s.shape[-2]
            if spad > 0:
                partners_s = torch.cat([partners_s, partners_s.new_full(
                    (*partners_s.shape[:-2], spad, partners_s.shape[-1]), -1)],
                    -2)
            asas = asas.replace(partners_s=partners_s.reshape(
                asas.partners_s.shape))
        if kern_reso == "swarm":
            # the whole swarm follows ASAS once a conflict triggered a
            # resolve
            act_new = torch.where(nconf > 0, ac.active, act_new)
        asas = asas.replace(
            active=act_new & cfg.reso_on,
            inconf=rd.inconf,
            tcpamax=rd.tcpamax.to(asas.tcpamax.dtype),
            nconf_cur=rd.nconf,
            nlos_cur=rd.nlos)
    if worlds:
        asas = asas.replace(partners=_local_ids(asas.partners, nw, n))
        return unflatten_worlds(state.replace(asas=asas), stacked), rd_out
    return state.replace(asas=asas), rd_out
