"""Sparse segment-scheduled CD&R: near-physics-floor pair enumeration.

Port of ``bluesky_tpu/ops/cd_sched.py``:

* **Stripe sort** (``stripe_sort_dest``): aircraft ordered by latitude
  stripe (stripe height >= the reach radius), longitude within the
  stripe, each stripe padded to a block boundary, so the reachable
  columns of a row block form about one contiguous run per stripe.
* **Segment schedule** (``build_windows``): each row's reachable blocks
  (``cd_tiled.block_reachability``, an exact bound) are covered by at
  most ``s_cap`` contiguous segments of at most ``wmax`` blocks; rows
  needing more are overflow rows.
* **Segment kernel** (``sched_tiles``): each row block's segment blocks
  are cut into balanced work items (``window_items``), one CTA per item
  (the hand-written CUDA kernel ``cd_sched_tiles`` of
  ``csrc/cd_tiles.cu``, replacing the Pallas ``_sched_kernel``), and the
  row merge ``cd_merge_items`` folds them and merges the partners.  Overflow
  rows are covered exactly by ``cd_pallas.full_grid_resume`` restricted
  to those rows (the same walker and merge over their reachable blocks),
  and the row-disjoint outputs merged with ``torch.where``.

No step here waits for the device: the overflow fallback is always
launched, on the row-restricted reachability, so rows without overflow
leave it at once.  Semantics are those of the JAX module: the schedule
only changes which provably conflict-free tiles are skipped.  Both
kernels run in the resolver form of the interval (``reso``: MVP, Eby or
Swarm, see ``cd_pallas``); Swarm widens the reachability to its
neighbourhood.

The shard modes (``detect_resolve_sched(mesh=..., shard_mode=...)``) run
on a single-process mesh: a grid of torch devices, which may repeat one
device (``parallel/sharding.py``).  JAX's collectives become explicit
copies and sums in a fixed order of shards, so each mode's mesh result
is bit-equal to its single-device reference:

* ``replicate``: shard d walks the row blocks d, d + D, ... against the
  replicated columns (the walker's row-subset form, ``rstride`` = D);
* ``spatial``: shard d owns a contiguous latitude-stripe block range,
  builds its slabs, summaries and windows locally, receives the halo
  blocks of its neighbours, and walks its rows against the halo window
  (the ``col0`` form);
* ``tiles``: shard t owns tile t of the tile-major layout
  (``tile_sort_dest``), receives the reach-selected blocks of its
  edge and corner neighbours, and walks its rows against the present
  set ranked by global block id (the ``gid`` table form).  Without a
  mesh the same construction runs tile by tile on one device: the
  single-device tiles reference.

The host layout of these modes (``spatial_layout``, ``tile_offsets``,
``tile_wire_blocks``, ``tile_sort_dest``) is plain tensor code.
"""
from typing import NamedTuple

import numpy as np
import torch

from . import cd_pallas, cd_tiled, cr_swarm
from .cd_pallas import (_BIG, _BIG_I, _FIELDS, _NF, N_SWARM, MeshForm,
                        TileParams, launch_key, mesh_shards, on_device)
from .cd_tiled import (RowConflictData, block_reachability, precompute_trig,
                       take, take_ids, take_rows)
from . import geo
from ..parallel.dist import allgather_shards, process_index, spans_ranks
from ..obs.trace import get_recorder

#: The ``LAUNCHES`` name of the segment pass's no-resume form (JAX
#: ``_sched_kernel`` with ``rpz_m=None``: no partner table), the C entry
#: ``cd_sched_tiles`` with a null ``pold``.
NORESUME = "cd_sched_tiles_noresume"
#: Launches of the CUDA kernel in each resolver form and mesh form since
#: the last reset, and of its no-resume form (one device or the
#: replicate row split).
LAUNCHES = {**{launch_key("cd_sched_tiles", r, m): 0
               for r in cd_pallas.RESO_CODE
               for m in (None,) + cd_pallas.MESH_KINDS},
            **{launch_key(NORESUME, r, m): 0
               for r in cd_pallas.RESO_CODE for m in (None, "rows")}}


def padded_size(n, block=256, extra=32):
    """Total slots of the padded stripe-sorted layout for n aircraft."""
    block = min(block, 256)
    return (-(-n // block) + extra) * block


def spatial_layout(n, block=256, ndev=1, extra=32):
    """Padded-layout parameters of the spatial and tiles modes: the
    extra-block count (at most ``extra``, at least 2) that makes the
    padded block count divide into ``ndev`` shards.  Returns
    ``(extra_eff, nb, nb_local, n_tot)``."""
    block = min(block, 256)
    nb0 = -(-n // block)
    extra_eff = extra - ((nb0 + extra) % ndev)
    if extra_eff < 2:
        extra_eff += ndev
    nb = nb0 + extra_eff
    return extra_eff, nb, nb // ndev, nb * block


def slot_inverse(perm, n, n_tot, fill=-1):
    """[n_tot + 1] int32 lookup: padded-slot id -> caller index (``fill``
    for empty slots); the +1 row makes clipped sentinel lookups safe.
    ``perm`` [W, n] gives each world's [W, n_tot + 1]."""
    lead = perm.shape[:-1]
    inv = torch.full((*lead, n_tot + 1), fill, dtype=torch.int32,
                     device=perm.device)
    ar = torch.arange(n, dtype=torch.int32, device=perm.device)
    return inv.scatter_(-1, torch.clamp(perm, 0, n_tot).long(),
                        ar.expand(*lead, n))


def partners_to_caller(perm, partners_s, n, n_tot):
    """The sorted-space partner table ``partners_s`` [n_tot, K] as a
    caller-space [n, K] table (-1 empty): partner slots map through
    ``slot_inverse``, and caller row i reads the row of its slot
    ``perm[i]``.  With a leading world axis each world maps through its
    own ``perm``."""
    inv = slot_inverse(perm, n, n_tot)
    ps = torch.clamp(partners_s, 0, n_tot).long()
    pc = torch.where(partners_s >= 0, take_ids(inv, ps),
                     torch.full_like(partners_s, -1))
    return take_rows(pc, torch.clamp(perm, 0, n_tot - 1).long())


def reach_threshold_m(gs, active, tlookahead, rpz):
    """Worst-case reach radius [m] at fleet-max closing speed ([W, 1] per
    world for columns with a leading world axis)."""
    gsmax = torch.where(active, gs, torch.zeros_like(gs))
    gsmax = gsmax.max() if gs.ndim == 1 else gsmax.amax(-1, keepdim=True)
    return rpz + tlookahead * 2.0 * gsmax


#: Vertical speed [m/s] past which an aircraft sorts into the climber
#: bucket of its stripe under the altitude layering (JAX ``_CLIMB_VS``).
_CLIMB_VS = 1.0


def _masked_range(a, act, fill_lo, fill_hi):
    """``(min, max)`` of ``a`` over the active entries of each world
    ([..., 1]), ``fill_lo`` / ``fill_hi`` for a world with none."""
    big = torch.full((), 1e9, dtype=a.dtype, device=a.device)
    any_act = act.any(-1, keepdim=True)
    lo = torch.where(any_act, torch.where(act, a, big).amin(-1, keepdim=True),
                     torch.full((), fill_lo, dtype=a.dtype, device=a.device))
    hi = torch.where(any_act, torch.where(act, a, -big).amax(-1, keepdim=True),
                     torch.full((), fill_hi, dtype=a.dtype, device=a.device))
    return lo, hi


def _auto_layers(lat, lon, alt, active, thresh_m):
    """The altitude-layer count of ``n_layers="auto"`` (JAX
    ``_auto_layers``), decided on the device: the mean count of
    reachable neighbours over the active bounding box; above 3000 (the
    horizontal windows saturated, as on the 230 nm circle at 100k)
    about one layer per 500 m of the active altitude range, at most 16,
    else 0.  [..., 1] int32."""
    act = active
    n_act = act.sum(-1, keepdim=True)

    def ptp(a):
        lo, hi = _masked_range(a, act, 0.0, 0.0)
        return hi - lo
    dlat_km = torch.clamp_min(ptp(lat), 0.3) * 111.0
    abslat = _masked_range(torch.abs(lat), act, 0.0, 0.0)[1]
    coslat = torch.clamp_min(torch.cos(geo.radians(abslat)), 0.05)
    dlon_km = torch.clamp_min(ptp(lon), 0.3) * 111.0 * coslat
    reach_km = thresh_m / 1000.0
    nbrs = n_act.to(lat.dtype) * np.pi * reach_km ** 2 / (dlat_km * dlon_km)
    l0 = torch.clamp(ptp(alt) / 500.0, 0, 16).to(torch.int32)
    use = (nbrs > 3000.0) & (l0 >= 2) & (n_act > 0)
    return torch.where(use, l0, torch.zeros_like(l0))


def _layers(alt, vs, active, nl):
    """Each aircraft's altitude layer within its stripe (JAX
    ``_stripe_sort_dest_impl``): ``nl`` equal bands of the active
    altitude range, the climbers and descenders (``|vs| > _CLIMB_VS``)
    in band ``nl``; 0 everywhere when ``nl`` is 0."""
    amin, amax = _masked_range(alt, active, 0.0, 1.0)
    lh = torch.clamp_min((amax - amin) / torch.clamp_min(nl, 1), 1.0)
    layer = torch.minimum(torch.clamp_min(torch.floor((alt - amin) / lh), 0),
                          torch.clamp_min(nl - 1, 0)).to(torch.int32)
    layer = torch.where(torch.abs(vs) > _CLIMB_VS, nl.expand_as(layer), layer)
    return torch.where(nl > 0, layer, torch.zeros_like(layer))


def stripe_sort_dest(lat, lon, gs, active, thresh_m, block, extra,
                     alt=None, vs=None, n_layers=0, spread_pad=False):
    """Per-aircraft destination slots of the padded stripe-major layout.
    Inactive aircraft sort into the last stripe.  Divisions by constants
    are the products with the reciprocal that compiled JAX computes.
    Columns with a leading world axis [W, n] (``thresh_m`` [W, 1]) sort
    each world on its own.

    With ``alt`` and ``vs`` and ``n_layers`` > 0 (or ``"auto"``: the
    count of ``_auto_layers``, decided on the device) the aircraft of
    each stripe are sub-ordered by altitude band, climbers in a band of
    their own, then by longitude, so that blocks are homogeneous in
    altitude and the vertical term of the reachability skips whole
    bands; every refresh of the serving path keeps ``n_layers=0``, as
    JAX's does.  ``spread_pad`` (the spatial layout) spreads the free
    padding blocks between the stripes in proportion to their
    cumulative active count, so that equal block ranges hold about equal
    aircraft counts; the inactive stripe stays at the end."""
    lead = lat.shape[:-1]
    n = lat.shape[-1]
    dev = lat.device
    act = active
    latmin, latmax = _masked_range(lat, act, 0.0, 1.0)
    span = torch.clamp_min(latmax - latmin, 1e-6)
    h = torch.clamp_min(torch.maximum(
        thresh_m * 1.05 * (1.0 / 110000.0),
        span * (1.0 / (extra - 1))), 0.05)
    s = torch.clamp(torch.floor((lat - latmin) / h), 0, extra - 2) \
        .to(torch.int32)
    s = torch.where(act, s, torch.full_like(s, extra - 1))
    qlon = torch.clamp((lon + 180.0) * (2 ** 19 / 360.0), 0, 2 ** 19 - 1)
    if alt is None or (n_layers != "auto" and int(n_layers) == 0):
        key = s.long() * (2 ** 19) + qlon.to(torch.int32)
    else:
        nl = _auto_layers(lat, lon, alt, act, thresh_m) \
            if n_layers == "auto" else torch.full(
                (*lead, 1), int(n_layers), dtype=torch.int32, device=dev)
        layer = _layers(alt, vs, act, nl)
        key = (s.long() * (nl.long() + 1) + layer) * (2 ** 19) \
            + qlon.to(torch.int32)
    order = torch.argsort(key, dim=-1, stable=True)    # sorted -> original
    ss = take(s, order).long()
    # a count by scatter_add, not bincount: on the card bincount reads
    # the largest index back to the host to size its output
    counts = torch.zeros((*lead, extra), dtype=torch.int64,
                         device=dev).scatter_add_(-1, ss, torch.ones_like(ss))
    nblocks = (counts + block - 1) // block
    zero = torch.zeros((*lead, 1), dtype=counts.dtype, device=dev)
    base = torch.cat([zero, torch.cumsum(nblocks, -1)[..., :-1]], -1)
    if spread_pad:
        free = -(-n // block) + extra - nblocks.sum(-1, keepdim=True)
        act_counts = counts.clone()
        act_counts[..., extra - 1] = 0
        cc = torch.cat([zero, torch.cumsum(act_counts, -1)[..., :-1]], -1)
        n_act = torch.clamp_min(act_counts.sum(-1, keepdim=True), 1)
        pad_before = free * cc // n_act
        pad_before[..., extra - 1:] = free
        base = base + pad_before
    base = base * block
    first = torch.cat([zero, torch.cumsum(counts, -1)[..., :-1]], -1)
    rank = torch.arange(n, device=dev) - take(first, ss)
    dest = torch.zeros((*lead, n), dtype=torch.int32, device=dev)
    return dest.scatter_(-1, order, (take(base, ss) + rank).to(torch.int32))


def scatter_padded(arrs, dest, n_tot, neutral=0.0, sentinel=False):
    """Place per-aircraft columns into the padded sorted layout (per
    world, for columns with a leading world axis).  With ``sentinel`` a
    destination ``n_tot`` (an inactive row of the spatial and tiles
    layouts, or any past it) is dropped, as JAX's scatter drops it;
    without, every destination must lie in the layout."""
    idx = torch.clamp(dest.long(), 0, n_tot) if sentinel else dest.long()
    out = []
    for a in arrs:
        z = torch.full((*a.shape[:-1], n_tot + sentinel), neutral,
                       dtype=a.dtype, device=a.device)
        z = z.scatter_(-1, idx, a)
        out.append(z[..., :n_tot].contiguous() if sentinel else z)
    return out


def build_windows(reach, s_cap, wmax, pad_start):
    """Cover each row's reachable columns with <= s_cap segments of
    <= wmax blocks.  Returns ``(start, ln, overflow)``: [nbr, s_cap]
    int32 (unused slots start=pad_start, ln=0) and the overflow rows."""
    nbr, nb = reach.shape
    dev = reach.device
    col = torch.arange(nb, dtype=torch.int64, device=dev)
    zcol = torch.zeros((nbr, 1), dtype=torch.bool, device=dev)
    prev = torch.cat([zcol, reach[:, :-1]], 1)
    nxt = torch.cat([reach[:, 1:], zcol], 1)
    starts = reach & ~prev
    rs = torch.cummax(torch.where(starts, col, torch.full_like(col, -1)),
                      dim=1).values
    off = col - rs
    newseg = reach & (starts | (off % wmax == 0))
    segend = reach & (~nxt | (off % wmax == wmax - 1))
    nseg = newseg.sum(1)
    overflow = nseg > s_cap
    want = torch.arange(1, s_cap + 1, dtype=torch.int64, device=dev)
    want_r = want[None, :].expand(nbr, s_cap).contiguous()
    st = torch.searchsorted(torch.cumsum(newseg, 1), want_r, side="left")
    en = torch.searchsorted(torch.cumsum(segend, 1), want_r, side="left")
    valid = want[None, :] <= nseg[:, None]
    ln = torch.where(valid, en - st + 1, torch.zeros_like(st))
    use = valid & ~overflow[:, None]
    st = torch.where(use, st, torch.full_like(st, pad_start))
    ln = torch.where(use, ln, torch.zeros_like(ln))
    return st.to(torch.int32), ln.to(torch.int32), overflow


def tile_offsets(tiles, hr=1, hc=1):
    """Canonical neighbour offsets ``(dr, dc mod C)`` of the R x C tile
    mesh: the edge and corner neighbours of the ``(2 hr + 1) x (2 hc +
    1)`` block minus self, longitude wrapping and latitude not, offsets
    that alias under the wrap kept once (a 4x2 mesh has 5, not 8)."""
    R, C = int(tiles[0]), int(tiles[1])
    offs, seen = [], set()
    for dr in range(-hr, hr + 1):
        if abs(dr) >= R and dr != 0:
            continue                     # no (src, dst) pair exists
        for dc in range(-hc, hc + 1):
            key = (dr, dc % C)
            if key == (0, 0) or key in seen:
                continue                 # self (incl. wrap-to-self)
            seen.add(key)
            offs.append(key)
    return tuple(offs)


def _offset_pairs(tiles, off):
    """The (sender, receiver) tile pairs of one canonical offset over the
    row-major (lat, lon) tile order: longitude wraps, latitude clips
    (an edge tile receives nothing: invalid columns)."""
    R, C = int(tiles[0]), int(tiles[1])
    dr, dcm = off
    return [(r * C + c, (r + dr) * C + (c + dcm) % C)
            for r in range(R) for c in range(C) if 0 <= r + dr < R]


def tile_wire_blocks(tiles, budgets=None, nb_t=0):
    """Worst-case received halo blocks per tile for the canonical offset
    set: the sum of the per-offset budgets (each capped at ``nb_t`` when
    given), or ``nb_t`` per offset when unpinned."""
    offs = tile_offsets(tiles)
    if budgets:
        return int(sum(min(int(b), nb_t) if nb_t else int(b)
                       for b in budgets))
    return int(len(offs) * nb_t)


def tile_sort_dest(lat, lon, gs, active, thresh_m, block, extra, tiles,
                   alt=None, vs=None):
    """Tile-major sort destinations of the 2-D lat x lon decomposition
    (JAX ``tile_sort_dest``): tile ``t = r * C + c`` owns the slots
    ``[t * S_t, (t + 1) * S_t)``, ``S_t = (nb // (R * C)) * block``.
    Whole reach-height latitude stripes are grouped into R bands by
    cumulative active count, and fixed 0.35 deg longitude cells of each
    band into C chunks likewise; within a tile the aircraft pack by
    (stripe, lon).  An over-dense stripe or cell can overflow its tile,
    which the tile refresh refuses.  Inactive aircraft get the last
    slot.  One world.  ``alt`` and ``vs`` are taken and unread, as in
    JAX (the tile layout has no altitude layering)."""
    R, C = int(tiles[0]), int(tiles[1])
    D = R * C
    n = lat.shape[0]
    dev = lat.device
    nb = -(-n // block) + extra
    n_tot = nb * block
    S_t = (nb // D) * block
    act = active
    big = torch.full((), 1e9, dtype=lat.dtype, device=dev)
    any_act = act.any()
    zero = torch.zeros((), dtype=lat.dtype, device=dev)
    latmin = torch.where(any_act, torch.where(act, lat, big).min(), zero)
    latmax = torch.where(any_act, torch.where(act, lat, -big).max(),
                         torch.ones((), dtype=lat.dtype, device=dev))
    span = torch.clamp_min(latmax - latmin, 1e-6)
    h = torch.clamp_min(torch.maximum(
        thresh_m * 1.05 * (1.0 / 110000.0),
        span * (1.0 / (extra - 1))), 0.05)
    s = torch.clamp(torch.floor((lat - latmin) / h), 0, extra - 2).long()
    s = torch.where(act, s, torch.full_like(s, extra - 1))
    acti = act.long()
    # stripe -> band: count-proportional over whole stripes
    sc = torch.zeros(extra, dtype=torch.int64, device=dev) \
        .scatter_add_(0, s, acti)
    csum = torch.cumsum(sc, 0) - sc
    n_act = torch.clamp_min(acti.sum(), 1)
    band_of = torch.clamp(((csum + sc // 2) * R) // n_act, 0, R - 1)
    band = band_of[s]
    # (band, cell) -> lon chunk: count-proportional over whole cells
    ncell = 1024
    cell = torch.clamp(((lon + 180.0) * (ncell / 360.0)).to(torch.int32),
                       0, ncell - 1).long()
    bc = torch.zeros(R * ncell, dtype=torch.int64, device=dev) \
        .scatter_add_(0, band * ncell + cell, acti).reshape(R, ncell)
    ccsum = torch.cumsum(bc, 1) - bc
    btot = torch.clamp_min(bc.sum(1), 1)
    chunk_of = torch.clamp(((ccsum + bc // 2) * C) // btot[:, None], 0,
                           C - 1)
    tile = band * C + chunk_of[band, cell]
    # pack the actives contiguously per tile, (stripe, lon) within
    qlon = torch.clamp((lon + 180.0) * (2 ** 19 / 360.0), 0,
                       2 ** 19 - 1).to(torch.int32).long()
    key = s * 2 ** 19 + qlon
    tile_a = torch.where(act, tile, torch.full_like(tile, D))
    order1 = torch.argsort(key, stable=True)
    order = order1[torch.argsort(tile_a[order1], stable=True)]
    ta_o = tile_a[order]
    start = torch.searchsorted(ta_o, torch.arange(D + 1, device=dev),
                               side="left")
    rank_o = torch.arange(n, device=dev) - start[torch.clamp(ta_o, 0, D)]
    dest_o = torch.where(ta_o < D,
                         torch.clamp(ta_o * S_t + rank_o, 0, n_tot - 1),
                         torch.full_like(ta_o, n_tot - 1))
    dest = torch.zeros(n, dtype=torch.int32, device=dev)
    return dest.scatter_(0, order, dest_o.to(torch.int32))


def _tile_select(reach_any, budget, nb_t):
    """Budget-capped export selection: the ascending local block ids of
    the sender's blocks a receiver row can reach.  Returns ``(sidx
    [budget] clipped ids, valid [budget])``."""
    ar = torch.arange(nb_t, dtype=torch.int64, device=reach_any.device)
    selkey = torch.where(reach_any, ar, torch.full_like(ar, nb_t))
    sidx = torch.sort(selkey).values[:budget]
    return torch.clamp(sidx, 0, nb_t - 1), sidx < nb_t


def _tile_windows(reach_rows, gkey, nb, s_cap_t, wmax):
    """Sort the present (own and received) column slabs by global block
    id and build the tile's segment windows over them, shared by the
    tiles mesh and the single-device tiles reference so that both visit
    the same columns.  An overflow row gets a synthetic full-present
    coverage (disjoint ``wmax``-block segments over every present slab)
    instead of the full-grid fallback.  ``gkey`` [ncols]: the candidate
    columns' global block ids, ``nb`` for an invalid one.  Returns
    ``(order, gid_tab, wst, wln)``: the slab order, the global block id
    of each slab (invalid ``nb``) and the windows."""
    ncols = gkey.shape[0]
    order = torch.argsort(gkey, stable=True)
    gid_tab = gkey[order]
    vcol = gid_tab < nb
    reach_h = reach_rows[:, torch.clamp(gid_tab, 0, nb - 1)] & vcol[None, :]
    st, ln, overflow = build_windows(reach_h, s_cap_t, wmax,
                                     pad_start=ncols)
    ist = torch.arange(s_cap_t, dtype=torch.int32,
                       device=gkey.device) * wmax
    fln = torch.clamp(ncols - ist, 0, wmax)
    st = torch.where(overflow[:, None], torch.clamp_max(ist, ncols),
                     torch.clamp(st, 0, ncols))
    ln = torch.where(overflow[:, None], fln, ln)
    return order, gid_tab.to(torch.int32), st.to(torch.int32), \
        ln.to(torch.int32)


def sched_tiles_plain(packed, wst, wln, wmax, pold, p: TileParams,
                      reso="mvp", nbw=None, mesh: MeshForm = None,
                      kk=cd_pallas.KK, rows=None):
    """Plain PyTorch version of the ``_sched_kernel`` pass: row block i
    walks its segments ``[wst[i, s], wst[i, s] + min(wln[i, s], wmax))``
    in slot order, blocks past the grid skipped.  Returns the 13
    outputs, 20 in the swarm form (see ``cd_pallas.row_block_plain``);
    with ``pold`` None the no-resume form (``rpz_m=None``): the 10
    outputs (17) with top-``kk`` candidates.
    With ``nbw`` the rows are a stack of worlds of ``nbw`` blocks each:
    the segments hold world-local blocks, past ``nbw`` skipped, and the
    slot ids and ``pold`` are global (``cd_pallas.full_grid_resume_plain``).
    With ``mesh`` (``cd_pallas.MeshForm``) the rows are ``mesh.own``'s
    and the segments hold local blocks of the column slabs ``packed``,
    lifted to global ids by the form's maps.  ``rows`` gives the outputs
    of those row blocks only (``cd_pallas.rows_plain``)."""
    nb, _, B = packed.shape
    nbw = nb if nbw is None else nbw
    st = wst.cpu().numpy()
    ln = np.minimum(wln.cpu().numpy(), wmax)
    base = (lambda i: i // nbw * nbw) if mesh is None else (lambda i: 0)

    def ids(i):
        t = [np.arange(b, b + k) for b, k in zip(st[i], ln[i]) if k > 0]
        t = np.concatenate(t) if t else np.zeros(0, np.int64)
        return cd_pallas.block_ids(t[t < nbw] + base(i), B)

    return cd_pallas.rows_plain(packed, pold, ids, p, reso, kk, mesh=mesh,
                                rows=rows)


def window_items(wst, wln, wmax, nbc, per_row=cd_pallas.ITEMS_PER_ROW,
                 worlds=True):
    """``cd_pallas.work_items`` of the segment pass: row i's tiles are its
    segments' blocks ``[wst[i, s], wst[i, s] + min(wln[i, s], wmax))`` in
    segment order, blocks past the grid's ``nbc`` left out (ascending:
    ``build_windows`` gives disjoint segments in slot order).  A stack of
    worlds of ``nbc`` row blocks each ([W * nbc, s_cap] windows) offsets
    each row's tiles by its world's first block; with ``worlds`` False
    (a mesh form's rows against ``nbc`` column slabs) nothing is
    offset."""
    nb, s_cap = wst.shape
    t = torch.arange(wmax, dtype=torch.int64, device=wst.device)
    cand = wst.long()[:, :, None] + t
    valid = (t < torch.clamp(wln.long(), 0, wmax)[:, :, None]) & (cand < nbc)
    if worlds and nb != nbc:
        cand = cand + cd_pallas.world_base(nb, nbc, wst.device)[:, None, None]
    return cd_pallas.work_items(
        *cd_pallas.compact_rows(cand.reshape(nb, s_cap * wmax),
                                valid.reshape(nb, s_cap * wmax)), per_row)


def sched_tiles(packed, wst, wln, wmax, pold, p: TileParams,
                per_row=cd_pallas.ITEMS_PER_ROW, reso="mvp", nbw=None,
                mesh: MeshForm = None, kk=cd_pallas.KK):
    """The segment pass: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see ``sched_tiles_plain``).  On the card each
    row's segment blocks are cut into at most ``per_row`` work items
    (``window_items``), walked by ``cd_sched_tiles`` and folded, with the
    partner merge, by ``cd_merge_items``; nothing waits for the device.
    With ``pold`` None both run their no-resume form (no partner table,
    top-``kk`` candidates: the 10 outputs, 17 in the swarm form).
    A stack of worlds of ``nbw`` row blocks each is one launch of each
    kernel for the whole stack.  ``mesh`` runs the walker's mesh form
    (``cd_pallas.MeshForm``): the rows of ``mesh.own`` against the
    column slabs ``packed``, whose local blocks the windows hold."""
    if not packed.is_cuda:
        return sched_tiles_plain(packed, wst, wln, wmax, pold, p, reso, nbw,
                                 mesh, kk)
    from . import _cuda
    if mesh is None:
        nb, B = cd_pallas.check_common(packed, pold, kk=kk, reso=reso)
        nbc = nb if nbw is None else nbw
    else:
        nb, nbc, B = cd_pallas.check_mesh(packed, mesh, pold, kk=kk,
                                          reso=reso)
    s_cap = wst.shape[1]
    _cuda.require(wst, torch.int32, (nb, s_cap), "wst")
    _cuda.require(wln, torch.int32, (nb, s_cap), "wln")
    items = window_items(wst, wln, int(wmax), nbc, per_row,
                         worlds=mesh is None)
    parts = cd_pallas.walk_items(packed, items, p, pold, reso=reso, kk=kk,
                                 mesh=mesh)
    outs = cd_pallas.merge_items(parts, items, B, pold, reso)
    LAUNCHES[launch_key("cd_sched_tiles" if pold is not None
                        else NORESUME, reso,
                        None if mesh is None else mesh.kind)] += 1
    return outs


class SchedInputs(NamedTuple):
    """The kernel operands of one interval and the layout they live in.
    A stack of W worlds stacks the row blocks (row w * nb + i is world
    w's block i) and keeps world-local block ids in the windows and the
    reachability; the partner ids in ``pold`` are global (world w's slot
    s is ``w * n_tot + s``), as the kernels number the slots."""
    packed: torch.Tensor      # [W * nb, 16, B] f32 slabs (cd_pallas._FIELDS)
    wst: torch.Tensor         # [W * nb, s_cap] int32 segment starts
    wln: torch.Tensor         # [W * nb, s_cap] int32 segment lengths
    wmax: int                 # blocks per segment at most
    overflow: torch.Tensor    # [W * nb] bool rows left to the full grid
    reach: torch.Tensor       # [W * nb, nb] bool block reachability
    pold: torch.Tensor        # [W * nb, kk, B] int32 old partners, or
    #                           None (the no-resume form)
    perm: torch.Tensor        # [(W,) n] int32 caller slot -> padded slot
    n: int
    n_tot: int                # padded slots per world
    nb: int                   # row blocks per world
    block: int
    reso: str = "mvp"         # the tile body's resolver form
    worlds: int = 1
    kk: int = cd_pallas.KK    # partner width (top-K of the no-resume form)


def _columns(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active, noreso,
             tas=None, cas=None, reso="mvp"):
    """The float32 per-aircraft columns the slabs are built from, with
    the resolver's ``tr`` row (``cd_pallas.tr_row``)."""
    f = lambda a: a.to(torch.float32)
    tr = cd_pallas.tr_row(gs, {k: v for k, v in (("tas", tas), ("cas", cas))
                               if v is not None}, reso)
    return {"lat": f(lat), "lon": f(lon), "trk": f(trk), "gs": f(gs),
            "alt": f(alt), "vs": f(vs), "gse": f(gseast), "gsn": f(gsnorth),
            "tr": f(tr), "active": f(active), "noreso": f(noreso)}


def _pack(padded, block):
    """The [nb, 16, B] slabs (``cd_pallas._FIELDS``) of padded columns
    (stacked along the row-block axis for a leading world axis)."""
    fields = precompute_trig(padded["lat"], padded["lon"])
    trkrad = geo.radians(padded["trk"])
    fields.update({
        "u": padded["gs"] * torch.sin(trkrad),
        "v": padded["gs"] * torch.cos(trkrad),
        "alt": padded["alt"], "vs": padded["vs"], "gse": padded["gse"],
        "gsn": padded["gsn"], "trk": padded["trk"], "tr": padded["tr"],
        "active": padded["active"], "noreso": padded["noreso"]})
    return torch.stack([fields[k] for k in _FIELDS]).reshape(
        _NF, -1, block).transpose(0, 1).contiguous()


def _reach_margins(reso):
    """The horizontal and vertical reach floors of the resolver form: the
    Swarm neighbourhood, else none."""
    return ((cr_swarm.R_SWARM, cr_swarm.DH_SWARM) if reso == "swarm"
            else (0.0, 0.0))


def prepare(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active, noreso,
            rpz, hpz, tlookahead, partners, block=256, s_cap=6, wmax=16,
            extra_blocks=32, perm=None, tas=None, cas=None,
            reso="mvp", sentinel=False, kk=cd_pallas.KK) -> SchedInputs:
    """Everything ``detect_resolve_sched`` hands the two kernels: the
    padded stripe-sorted slabs, the reachability, the segment windows and
    the partner table in kernel layout.  Always float32.  ``reso`` with
    ``tas`` (Eby) or ``cas`` (Swarm) fills the ``tr`` row
    (``cd_pallas.tr_row``); Swarm widens the reachability to its
    neighbourhood, horizontally and vertically.  Columns with a leading
    world axis [W, n] (``partners`` [W, n_tot, K] in world-local slots)
    give the stacked operands of every world (``SchedInputs``).  With
    ``sentinel`` a ``perm`` entry past the layout (the spatial and tiles
    layouts' sentinel of an inactive row) leaves that row out
    (``scatter_padded``).  ``partners`` None gives the operands of the
    no-resume form (``pold`` None, top-``kk`` candidates)."""
    lead = lat.shape[:-1]
    worlds = int(np.prod(lead, dtype=np.int64))
    n = lat.shape[-1]
    block = min(block, 256)
    cols = _columns(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
                    noreso, tas, cas, reso)
    if perm is None:
        thresh = reach_threshold_m(cols["gs"], active, float(tlookahead),
                                   float(rpz))
        perm = stripe_sort_dest(cols["lat"], cols["lon"], cols["gs"], active,
                                thresh, block, extra_blocks)
    nb = -(-n // block) + extra_blocks
    n_tot = nb * block
    padded = dict(zip(cols, scatter_padded(list(cols.values()), perm,
                                           n_tot, sentinel=sentinel)))
    packed = _pack(padded, block)
    swarm_m = _reach_margins(reso)
    reach = block_reachability(
        padded["lat"], padded["lon"], padded["gs"], padded["active"] > 0.5,
        nb, block, float(rpz), float(tlookahead), alt=padded["alt"],
        vs=padded["vs"], hpz=float(hpz), min_reach_m=swarm_m[0],
        min_vreach_m=swarm_m[1])
    reach = reach.reshape(-1, nb)
    st, ln, overflow = build_windows(reach, s_cap, wmax, pad_start=nb)
    pold = None
    if partners is not None:
        kk = partners.shape[-1]
        pold = _kernel_partners(partners, block)
        if lead:
            pold = torch.where(pold >= 0, pold + slot_base(
                worlds, nb, n_tot, pold.device), pold)
    return SchedInputs(packed=packed, wst=torch.clamp(st, 0, nb), wln=ln,
                       wmax=wmax, overflow=overflow, reach=reach, pold=pold,
                       perm=perm, n=n, n_tot=n_tot, nb=nb, block=block,
                       reso=reso, worlds=worlds, kk=kk)


def _kernel_partners(partners, block):
    """The partner table [.., n_tot, K] in kernel layout [nb, K, B]."""
    kk = partners.shape[-1]
    return partners.reshape(-1, block, kk).transpose(1, 2) \
        .to(torch.int32).contiguous()


def slot_base(worlds, nb, n_tot, device):
    """[W * nb, 1, 1] int32: the first global slot of each row block's
    world (world w's slot s is ``w * n_tot + s``)."""
    return (torch.arange(worlds * nb, device=device, dtype=torch.int32)
            // nb * n_tot)[:, None, None]


def _overflow_pass(packed, reach_f, pold, p, reso, kk, mesh=None):
    """The overflow rows' full-grid pass over ``reach_f``: K2
    (``full_grid_resume``) with the partner table, K3 (``full_grid``,
    JAX ``full_grid_pass`` without ``pold``) in the no-resume form."""
    if pold is None:
        return cd_pallas.full_grid(packed, reach_f, p, reso=reso, kk=kk,
                                   mesh=mesh)
    return cd_pallas.full_grid_resume(packed, reach_f, pold, p, reso=reso,
                                      mesh=mesh)


def run_kernels(x: SchedInputs, p: TileParams):
    """The segment pass plus the overflow fallback in the resolver form
    ``x.reso``, merged row-disjointly (the 13 outputs in kernel layout,
    20 in the swarm form; 10 and 17 in the no-resume form).  The passes
    are the spans ``cd.k1`` and ``cd.k2``; while the recorder counts,
    they carry the device counters ``cd_items`` and ``cd_k1_tiles`` (the
    walker's work items and tiles, as ``window_items`` cuts them),
    ``cd_k2_tiles`` and ``cd_overflow_rows`` (``reach & overflow`` and
    ``overflow``)."""
    rec = get_recorder()
    with rec.span("cd.k1", cat="cd", device=True):
        outs_s = sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p,
                             reso=x.reso, nbw=x.nb, kk=x.kk)
        if rec.counting:
            # window_items' counts and items, without building them: a
            # row's tiles, cut into items of ceil(count / per_row)
            count = torch.minimum(torch.clamp(x.wln, 0, int(x.wmax)),
                                  torch.clamp(x.nb - x.wst, min=0)).sum(1)
            size = torch.clamp((count + cd_pallas.ITEMS_PER_ROW - 1)
                               // cd_pallas.ITEMS_PER_ROW, min=1)
            rec.count("cd_items", ((count + size - 1) // size).sum())
            rec.count("cd_k1_tiles", count.sum())
    with rec.span("cd.k2", cat="cd", device=True):
        reach_f = x.reach & x.overflow[:, None]
        outs_f = _overflow_pass(x.packed, reach_f, x.pold, p, x.reso, x.kk)
        if rec.counting:
            rec.count("cd_k2_tiles", reach_f.sum())
            rec.count("cd_overflow_rows", x.overflow.sum())
    rsel = x.overflow[:, None, None]
    return [torch.where(rsel, f, s) for f, s in zip(outs_f, outs_s)]


def _run_rows(intr, wst, wln, wmax, overflow, reach, pold, p, reso, mesh,
              fallback=True, kk=cd_pallas.KK):
    """The segment pass in the mesh form ``mesh`` plus, with ``fallback``,
    the overflow rows' full-grid pass over ``reach`` (local columns),
    merged row-disjointly (``run_kernels`` of a row subset)."""
    outs_s = sched_tiles(intr, wst, wln, wmax, pold, p, reso=reso,
                         mesh=mesh, kk=kk)
    if not fallback:
        return list(outs_s)
    outs_f = _overflow_pass(intr, reach & overflow[:, None], pold, p, reso,
                            kk, mesh)
    rsel = overflow[:, None, None]
    return [torch.where(rsel, f, s) for f, s in zip(outs_f, outs_s)]


def _backed_neutral(reso, device):
    """The identity of each back-mapped row of a slot the schedule never
    touched (inconf, tcpamax, the three sums, tsolv, active, then the
    Swarm sums): what a sentinel row reads."""
    vals = [0.0, 0.0, 0.0, 0.0, 0.0, _BIG, 0.0] \
        + [0.0] * (N_SWARM if reso == "swarm" else 0)
    return torch.tensor(vals, dtype=torch.float32, device=device)[:, None]


def _back_rows(outs, resume=True):
    """The per-ownship outputs that map back to caller rows: the six
    reductions, the engagement flag (``resume``: not in the no-resume
    form) and the Swarm sums."""
    return list(outs[:6]) + list(outs[12 if resume else 10:])


def _local_backmap(outs, in_dev, dest_loc, S, kk, reso):
    """One shard's masked back-map to its caller rows: rows whose slot is
    not the shard's read the identities.  Returns ``(backed, topk_tin,
    topk_raw, merged, nconf, nlos)``."""
    stacked = torch.stack([o.reshape(S) for o in _back_rows(outs)])
    gsl = torch.clamp(dest_loc, 0, S - 1).long()
    backed = torch.where(in_dev[None, :], stacked[:, gsl],
                         _backed_neutral(reso, stacked.device))
    tt = outs[8].transpose(1, 2).reshape(S, kk)[gsl]
    ti = outs[9].transpose(1, 2).reshape(S, kk)[gsl]
    tt = torch.where(in_dev[:, None], tt, torch.full_like(tt, _BIG))
    ti = torch.where(in_dev[:, None], ti, torch.full_like(ti, _BIG_I))
    count = lambda c: c.to(torch.int32).sum(dtype=torch.int32)
    return backed, tt, ti, outs[11], count(outs[6]), count(outs[7])


def _shard_locals(cols, perm, shards, S, block, C):
    """Each shard's own slot range of the padded layout, built from its
    caller rows only: ``in_dev`` and ``dest_loc`` (the shard-local slot,
    ``S`` off the shard), the slabs and the block summaries, and ``own``:
    whether this process walks the shard.  Every process builds every
    shard from the replicated columns (the halo and tile exchanges read
    the neighbours' slabs), those of the shards other processes own on
    its own first shard's device."""
    devs, ranks, _ = shards
    me = process_index()
    home = devs[ranks.index(me)]
    out = []
    for d, dev in enumerate(devs):
        own = ranks[d] == me
        dev = dev if own else home
        with on_device(dev):
            perm_l = perm[d * C:(d + 1) * C].to(dev)
            base = d * S
            in_dev = (perm_l >= base) & (perm_l < base + S)
            dest_loc = torch.where(in_dev, perm_l - base,
                                   torch.full_like(perm_l, S))
            padded = dict(zip(cols, scatter_padded(
                [v[d * C:(d + 1) * C].to(dev) for v in cols.values()],
                dest_loc, S, sentinel=True)))
            nbl = S // block
            summ = cd_tiled.block_summaries(
                padded["lat"], padded["lon"], padded["gs"],
                padded["active"] > 0.5, nbl, block, alt=padded["alt"],
                vs=padded["vs"])
            out.append(dict(dev=dev, own=own, in_dev=in_dev,
                            dest_loc=dest_loc, packed=_pack(padded, block),
                            summ=summ))
    return out


def _gather(shards, key):
    """The all-gather of the shards' block summaries: one copy on each
    device of the mesh, returned for each shard this process owns in
    shard order (None for the others)."""
    got = {}
    for s in shards:
        if s["own"] and str(s["dev"]) not in got:
            got[str(s["dev"])] = {
                k: torch.cat([t[key][k].to(s["dev"]) for t in shards])
                for k in shards[0][key]}
    return [got[str(s["dev"])] if s["own"] else None for s in shards]


def _mesh_result(parts, home, n_tot, kk, reso, shards):
    """Join the shards' back-mapped results in shard order (the caller
    axis and the padded row blocks are shard-major), the counts summed
    in that order; across processes each rank's parts (None for the
    shards it does not own) are all-gathered first.  Returns ``(rd,
    partners_new, active[, swarm])``."""
    devs, ranks, guard = shards
    if spans_ranks(ranks):
        got = allgather_shards({d: list(q) for d, q in enumerate(parts)
                                if q is not None}, ranks, home, guard)
        parts = [got[d] for d in range(len(parts))]
    cat = lambda j, dim=0: torch.cat([q[j].to(home) for q in parts], dim)
    backed, topk_tin, ti_raw, merged = cat(0, 1), cat(1), cat(2), cat(3)
    nconf, nlos = parts[0][4].to(home), parts[0][5].to(home)
    for q in parts[1:]:
        nconf = nconf + q[4].to(home)
        nlos = nlos + q[5].to(home)
    topk_idx = torch.where((topk_tin < _BIG) & (ti_raw < n_tot), ti_raw,
                           torch.full_like(ti_raw, -1))
    rd = RowConflictData(
        inconf=backed[0] > 0.5, tcpamax=backed[1], sum_dve=backed[2],
        sum_dvn=backed[3], sum_dvv=backed[4], tsolv=backed[5],
        nconf=nconf, nlos=nlos, topk_idx=topk_idx, topk_tin=topk_tin)
    partners_new = merged.transpose(1, 2).reshape(n_tot, kk)
    if reso == "swarm":
        return rd, partners_new, backed[6] > 0.5, tuple(backed[7:])
    return rd, partners_new, backed[6] > 0.5


def _spatial_mesh(cols, perm, pold, shards, n, nb, block, kk, s_cap, wmax,
                  halo_blocks, p, reso, reach_kw):
    """The spatial mesh interval (JAX ``detect_resolve_sched`` spatial
    branch): shard d owns the stripe block range ``[d * nb_l, (d + 1) *
    nb_l)``; its scatter, slabs, summaries, reachability rows and windows
    come from its own caller rows, the summaries are gathered, the halo
    blocks of the neighbours (``n_hops`` shards each side) are copied in,
    and its rows walk the halo window in the ``col0`` form.  Returns one
    part per shard, None for the shards other processes own."""
    D = len(shards[0])
    nb_l = nb // D
    S_l = nb_l * block
    halo = int(halo_blocks) if halo_blocks else nb_l
    halo = min(halo, (D - 1) * nb_l)
    n_hops = -(-halo // nb_l)
    nbh = nb_l + 2 * halo
    locs = _shard_locals(cols, perm, shards, S_l, block, n // D)
    parts = []
    for d, (sh, summ_g) in enumerate(zip(locs, _gather(locs, "summ"))):
        if summ_g is None:
            parts.append(None)
            continue
        dev = sh["dev"]
        with on_device(dev):
            reach_rows = cd_tiled.reachability_from_summaries(
                sh["summ"], summ_g, **reach_kw)
            row0 = d * nb_l
            col0 = row0 - halo
            cg = col0 + torch.arange(nbh, device=dev)
            vcol = (cg >= 0) & (cg < nb)
            reach_h = reach_rows[:, torch.clamp(cg, 0, nb - 1)] \
                & vcol[None, :]
            st, ln, overflow = build_windows(reach_h, s_cap, wmax,
                                             pad_start=nbh)
            zeros = lambda m: sh["packed"].new_zeros((m, _NF, block))
            lo, hi = [], []
            for h in range(1, n_hops + 1):
                take_n = halo - (h - 1) * nb_l if h == n_hops else nb_l
                lo.insert(0, locs[d - h]["packed"][nb_l - take_n:].to(dev)
                          if d - h >= 0 else zeros(take_n))
                hi.append(locs[d + h]["packed"][:take_n].to(dev)
                          if d + h < D else zeros(take_n))
            intr = torch.cat(lo + [sh["packed"]] + hi)
            outs = _run_rows(
                intr, torch.clamp(st, 0, nbh), ln, wmax, overflow, reach_h,
                pold[row0:row0 + nb_l].to(dev), p, reso,
                MeshForm(own=sh["packed"], row0=row0, rstride=1, col0=col0))
            parts.append(_local_backmap(outs, sh["in_dev"], sh["dest_loc"],
                                        S_l, kk, reso))
    return parts


def _tile_config(tile_shape, tile_budgets, nb, s_cap, wmax):
    """The tile mesh's shape, offsets, per-offset budgets (each capped at
    the tile's ``nb_t`` blocks, the whole tile when unpinned) and the
    segment cap of a tile's present set."""
    tR, tC = int(tile_shape[0]), int(tile_shape[1])
    offs = tile_offsets((tR, tC))
    nb_t = nb // (tR * tC)
    if tile_budgets:
        if len(tile_budgets) != len(offs):
            raise ValueError(
                f"tile_budgets must carry one entry per canonical offset "
                f"({len(offs)} for {tR}x{tC}); got {len(tile_budgets)}")
        budgets = tuple(max(1, min(int(b), nb_t)) for b in tile_budgets)
    else:
        budgets = tuple(nb_t for _ in offs)
    s_cap_t = max(s_cap, -(-(nb_t + sum(budgets)) // wmax))
    return tR, tC, offs, nb_t, budgets, s_cap_t


def _tiles_mesh(cols, perm, pold, shards, n, nb, block, kk, wmax, tcfg, p,
                reso, reach_kw):
    """The tile mesh interval (JAX ``detect_resolve_sched`` tiles branch):
    shard t owns tile t's block range; each sender ships, per canonical
    offset, the budget-capped blocks its receiver's rows can reach
    (``_tile_select`` on the receiver's reachability rows, from the
    summaries gathered once a device), with their global ids,
    and each receiver walks its present set ranked by global block id in
    the ``gid`` form (``_tile_windows``; no full-grid fallback).  A
    process builds the exports its own shards receive.  Returns one part
    per shard, None for the shards other processes own."""
    tR, tC, offs, nb_t, budgets, s_cap_t = tcfg
    S_t = nb_t * block
    locs = _shard_locals(cols, perm, shards, S_t, block, n // (tR * tC))
    reach_rows = []
    for sh, summ_g in zip(locs, _gather(locs, "summ")):
        if summ_g is None:
            reach_rows.append(None)
            continue
        with on_device(sh["dev"]):
            reach_rows.append(cd_tiled.reachability_from_summaries(
                sh["summ"], summ_g, **reach_kw))
    exports = {}
    for o, (off, E) in enumerate(zip(offs, budgets)):
        for u, v in _offset_pairs((tR, tC), off):
            if reach_rows[v] is None:
                continue
            sh = locs[u]
            dev = sh["dev"]
            with on_device(dev):
                # the sender's blocks that the receiver's rows reach
                reach_out = reach_rows[v][:, u * nb_t:(u + 1) * nb_t]
                sidx, valid = _tile_select(reach_out.any(0).to(dev), E, nb_t)
                buf = torch.where(valid[:, None, None], sh["packed"][sidx],
                                  torch.zeros((), device=dev))
                gidp = torch.where(valid, u * nb_t + sidx + 1,
                                   torch.zeros_like(sidx))
                exports[o, v] = (buf, gidp)
    parts = []
    for t, sh in enumerate(locs):
        if reach_rows[t] is None:
            parts.append(None)
            continue
        dev = sh["dev"]
        with on_device(dev):
            gparts = [t * nb_t + torch.arange(nb_t, device=dev)]
            sparts = [sh["packed"]]
            for o, E in enumerate(budgets):
                if (o, t) in exports:
                    rbuf, rgid = (a.to(dev) for a in exports[o, t])
                else:          # an edge tile: the collective's zero fill
                    rbuf = sh["packed"].new_zeros((E, _NF, block))
                    rgid = torch.zeros(E, dtype=torch.int64, device=dev)
                gparts.append(torch.where(rgid > 0, rgid - 1,
                                          torch.full_like(rgid, nb)))
                sparts.append(rbuf)
            order, gid_tab, wst, wln = _tile_windows(
                reach_rows[t], torch.cat(gparts), nb, s_cap_t, wmax)
            outs = _run_rows(
                torch.cat(sparts)[order], wst, wln, wmax, None, None,
                pold[t * nb_t:(t + 1) * nb_t].to(dev), p, reso,
                MeshForm(own=sh["packed"], row0=t * nb_t, gid=gid_tab),
                fallback=False)
            parts.append(_local_backmap(outs, sh["in_dev"], sh["dest_loc"],
                                        S_t, kk, reso))
    return parts


def _tiles_reference(x: SchedInputs, p, tcfg):
    """The single-device tiles reference (JAX ``detect_resolve_sched``
    with ``shard_mode="tiles"`` and no mesh): tile by tile, the same
    selection, present set, windows and gid form as the mesh, over the
    global slabs.  Returns the outputs in kernel layout."""
    tR, tC, offs, nb_t, budgets, s_cap_t = tcfg
    nb, packed = x.nb, x.packed
    dev = packed.device
    chunks = []
    for t in range(tR * tC):
        r0t, c0t = divmod(t, tC)
        rows = slice(t * nb_t, (t + 1) * nb_t)
        rr = x.reach[rows]
        reach_any = rr.any(0)
        gparts = [t * nb_t + torch.arange(nb_t, device=dev)]
        sparts = [packed[rows]]
        for (dr, dcm), E in zip(offs, budgets):
            ru, cu = r0t - dr, (c0t - dcm) % tC
            if 0 <= ru < tR:
                u = ru * tC + cu
                sidx, valid = _tile_select(
                    reach_any[u * nb_t:(u + 1) * nb_t], E, nb_t)
                gparts.append(torch.where(valid, u * nb_t + sidx,
                                          torch.full_like(sidx, nb)))
                sparts.append(torch.where(valid[:, None, None],
                                          packed[u * nb_t + sidx],
                                          torch.zeros((), device=dev)))
            else:
                gparts.append(torch.full((E,), nb, dtype=torch.int64,
                                         device=dev))
                sparts.append(packed.new_zeros((E, _NF, x.block)))
        order, gid_tab, wst, wln = _tile_windows(rr, torch.cat(gparts), nb,
                                                 s_cap_t, x.wmax)
        chunks.append(_run_rows(
            torch.cat(sparts)[order], wst, wln, x.wmax, None, None,
            x.pold[rows], p, x.reso,
            MeshForm(own=packed[rows], row0=t * nb_t, gid=gid_tab),
            fallback=False))
    return [torch.cat(parts) for parts in zip(*chunks)]


def _replicate_rows(x: SchedInputs, p, shards):
    """The replicate row split (JAX ``detect_resolve_sched`` under a
    mesh, ``cd_pallas.split_rows``): shard d walks the row blocks d,
    d + D, ... against the replicated column slabs in the row-subset form
    (``rstride`` = D); across processes each rank walks its own shards
    and the rows are all-gathered.  Returns the outputs in kernel
    layout."""
    devs, ranks, guard = shards
    def run(d, rows, dev):
        return _run_rows(
            x.packed.to(dev), x.wst[rows].to(dev), x.wln[rows].to(dev),
            x.wmax, x.overflow[rows].to(dev), x.reach[rows].to(dev),
            None if x.pold is None else x.pold[rows].to(dev), p, x.reso,
            MeshForm(own=x.packed[rows].to(dev), row0=d, rstride=len(devs)),
            kk=x.kk)
    return cd_pallas.split_rows(x.nb, devs, x.packed.device, run, ranks,
                                guard)


def _check_shard_args(n, nb, resume, mesh, mesh_axis, shard_mode,
                     extra_blocks, tile_shape):
    """The shard-mode checks of the JAX function.  Returns ``(ndev_sp,
    mesh_tiles)``: the spatial mesh's shard count (0 without one) and
    whether a tile mesh of ``tile_shape`` runs the interval."""
    shape = dict(mesh.shape) if mesh is not None else {}
    ndev_sp = shape[mesh_axis] if (shard_mode == "spatial"
                                   and mesh_axis in shape) else 0
    if shard_mode not in ("replicate", "spatial", "tiles"):
        raise ValueError(f"Unknown shard_mode {shard_mode!r}; expected "
                         "'replicate', 'spatial' or 'tiles'.")
    if shard_mode == "spatial" and not resume:
        raise ValueError(
            "spatial shard mode requires the resume/partner-table path "
            "(the production sparse backend always passes `partners`)")
    if ndev_sp > 1 and nb % ndev_sp != 0:
        raise ValueError(
            f"spatial shard mode: padded block count nb={nb} must divide "
            f"into {ndev_sp} devices — build the layout with "
            f"cd_sched.spatial_layout (extra_blocks={extra_blocks})")
    if ndev_sp > 1 and n % ndev_sp != 0:
        raise ValueError(
            f"spatial shard mode: nmax={n} must be divisible by the "
            f"{ndev_sp}-device mesh")
    mesh_tiles = False
    if shard_mode == "tiles":
        if not tile_shape or len(tuple(tile_shape)) != 2:
            raise ValueError(
                "tiles shard mode needs tile_shape=(R, C) — set "
                "SimConfig.cd_tile_shape / SHARD TILE RxC")
        tR, tC = int(tile_shape[0]), int(tile_shape[1])
        tD = tR * tC
        if not resume:
            raise ValueError(
                "tiles shard mode requires the resume/partner-table path "
                "(the production sparse backend always passes `partners`)")
        if nb % tD:
            raise ValueError(
                f"tiles shard mode: padded block count nb={nb} must divide "
                f"into {tR}x{tC}={tD} tiles — build the layout with "
                f"cd_sched.spatial_layout (extra_blocks={extra_blocks})")
        mesh_tiles = tD > 1 and shape.get("lat") == tR \
            and shape.get("lon") == tC
        if mesh is not None and not mesh_tiles and tD > 1:
            raise ValueError(
                f"tiles shard mode needs a ('lat', 'lon') mesh of shape "
                f"{tR}x{tC}; got axes {shape} — build it with "
                "parallel.sharding.make_tile_mesh")
        if mesh_tiles and n % tD:
            raise ValueError(
                f"tiles shard mode: nmax={n} must be divisible by the "
                f"{tD}-device tile mesh")
    return ndev_sp, mesh_tiles


def _small_fleet(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
                 noreso, rpz, hpz, tlookahead, mvpcfg, block, k_partners,
                 tas, cas, reso):
    """The hand-off of a fleet of at most ``2 * block`` aircraft without
    a partner table (JAX ``detect_resolve_sched``: "too small to
    schedule"): ``cd_pallas.detect_resolve_pallas`` with the resolver
    column, the TAS for Eby, the CAS (else the ground speed) for
    Swarm."""
    extra = None
    if tas is not None:
        extra = {"tas": tas}
    if reso == "swarm":
        extra = {"cas": gs if cas is None else cas}
    return cd_pallas.detect_resolve_pallas(
        lat, lon, trk, gs, alt, vs, gseast, gsnorth, active, noreso, rpz,
        hpz, tlookahead, mvpcfg, block=block, k_partners=k_partners,
        reso=reso, extra_cols=extra)


def detect_resolve_sched(lat, lon, trk, gs, alt, vs, gseast, gsnorth,
                         active, noreso, rpz, hpz, tlookahead, mvpcfg,
                         partners=None, resume_rpz_m=0.0, block=256,
                         s_cap=6, wmax=16, extra_blocks=32, perm=None,
                         tas=None, cas=None, reso="mvp", mesh=None,
                         mesh_axis="ac", shard_mode="replicate",
                         halo_blocks=0, tile_shape=None, tile_budgets=(),
                         k_partners=cd_pallas.KK):
    """Sparse-scheduled CD&R (JAX ``detect_resolve_sched``).

    ``perm`` is the cached ``stripe_sort_dest`` table (recomputed when
    None; ``tile_sort_dest`` in the tiles mode).  ``reso`` is the
    resolver form of the pair sums, with ``tas`` (Eby) or ``cas``
    (Swarm).

    With ``partners`` [n_tot, K] int32, the sorted-space partner table,
    the kernels run in-kernel resume-nav (the production form), and the
    result is ``(rd, partners_new, active)``, with ``reso="swarm"``
    ``(rd, partners_new, active, swarm_sums)``: the per-ownship
    reductions in caller order (``rd.topk_*`` sorted-space ids), the
    merged sorted-space partner table, the caller-space ASAS engagement
    flags and the seven neighbour sums in caller order.  K may be any
    width the device's memory holds: past 32 the walker and the merge run
    their wide form (``cd_pallas``).

    Without ``partners`` (``resume_rpz_m`` unread) the no-resume form
    runs: a fleet of at most ``2 * block`` aircraft goes to
    ``cd_pallas.detect_resolve_pallas`` (``_small_fleet``), a larger one
    through the segment pass without a partner table and the overflow
    rows' full grid (K3's body), and the result is ``rd``, or ``(rd,
    swarm_sums)``, with ``rd.topk_idx`` in caller slots (top
    ``k_partners``).  It takes no leading world axis, and the spatial
    and tiles modes refuse it, as JAX's does.

    ``mesh`` (a single-process mesh, ``parallel/sharding.py``) and
    ``shard_mode`` pick the decomposition (module docstring): with a mesh
    of more than one shard, ``"replicate"`` splits the rows, ``"spatial"``
    runs the stripe mesh (``halo_blocks`` the window's half width, 0 one
    shard's blocks) and ``"tiles"`` the tile mesh of ``tile_shape`` (R, C)
    with the per-offset ``tile_budgets``.  Without a mesh ``"spatial"``
    only switches the back-map to its sentinel-masked form and
    ``"tiles"`` runs the single-device tiles reference.  Each mesh result
    is bit-equal to its reference.  The spatial and tiles layouts
    (``spatial_layout``) give inactive rows the sentinel slot ``n_tot``.

    Columns with a leading world axis [W, n] (``perm`` [W, n],
    ``partners`` [W, n_tot, K]) run W worlds in one interval, each kernel
    launched once for the stack; every result has the leading axis
    (``nconf``/``nlos`` [W]) and world-local slot ids.  A stack of worlds
    takes no mesh and no shard mode."""
    lead = lat.shape[:-1]
    n = lat.shape[-1]
    block = min(block, 256)
    resume = partners is not None
    if not resume:
        if lead:
            raise ValueError("detect_resolve_sched without partners takes "
                             "one world (no leading axis), as JAX's")
        if n <= 2 * block:
            return _small_fleet(lat, lon, trk, gs, alt, vs, gseast, gsnorth,
                                active, noreso, rpz, hpz, tlookahead, mvpcfg,
                                block, k_partners, tas, cas, reso)
    nb = -(-n // block) + extra_blocks
    n_tot = nb * block
    kk = partners.shape[-1] if resume else k_partners
    if lead and (mesh is not None or shard_mode != "replicate"):
        raise ValueError("a stack of worlds runs single-device per world: "
                         "no mesh and shard_mode 'replicate'")
    ndev_sp, mesh_tiles = _check_shard_args(
        n, nb, resume, mesh, mesh_axis, shard_mode, extra_blocks, tile_shape)
    p = cd_pallas.tile_params(rpz, hpz, tlookahead, mvpcfg, resume_rpz_m)
    if shard_mode == "tiles":
        tcfg = _tile_config(tile_shape, tile_budgets, nb, s_cap, wmax)
        if perm is None:
            f32 = lambda a: a.to(torch.float32)
            perm = tile_sort_dest(
                f32(lat), f32(lon), f32(gs), active,
                reach_threshold_m(f32(gs), active, float(tlookahead),
                                  float(rpz)),
                block, extra_blocks, tcfg[:2])
    if ndev_sp > 1 or mesh_tiles:
        swarm_m = _reach_margins(reso)
        reach_kw = dict(rpz=float(rpz), tlookahead=float(tlookahead),
                        hpz=float(hpz), min_reach_m=swarm_m[0],
                        min_vreach_m=swarm_m[1])
        cols = _columns(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
                        noreso, tas, cas, reso)
        pold = _kernel_partners(partners, block)
        shards = mesh_shards(mesh)
        if mesh_tiles:
            parts = _tiles_mesh(cols, perm, pold, shards, n, nb, block, kk,
                                wmax, tcfg, p, reso, reach_kw)
        else:
            parts = _spatial_mesh(cols, perm, pold, shards, n, nb, block,
                                  kk, s_cap, wmax, halo_blocks, p, reso,
                                  reach_kw)
        return _mesh_result(parts, lat.device, n_tot, kk, reso, shards)

    with get_recorder().span("cd.prepare", cat="cd", device=True):
        x = prepare(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
                    noreso, rpz, hpz, tlookahead, partners, block=block,
                    s_cap=s_cap, wmax=wmax, extra_blocks=extra_blocks,
                    perm=perm, tas=tas, cas=cas, reso=reso,
                    sentinel=shard_mode in ("spatial", "tiles"), kk=kk)
    if shard_mode == "tiles":
        outs = _tiles_reference(x, p, tcfg)
    elif mesh is not None and mesh.shape[mesh_axis] > 1:
        outs = _replicate_rows(x, p, mesh_shards(mesh))
    else:
        outs = run_kernels(x, p)
    with get_recorder().span("cd.back", cat="cd", device=True):
        return _to_caller(x, outs, lead, n, n_tot, kk, resume, reso,
                          shard_mode)


def _to_caller(x, outs, lead, n, n_tot, kk, resume, reso, shard_mode):
    """``detect_resolve_sched``'s result from the kernels' outputs
    ``outs``: the per-ownship reductions and the partner table back in
    caller order (the device span ``cd.back``)."""
    (inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt,
     ctin, cidx) = outs[:10]
    perm = x.perm.long()
    stacked = torch.stack([o.reshape(*lead, n_tot)
                           for o in _back_rows(outs, resume)])
    rows = lambda a: a.transpose(1, 2).reshape(*lead, n_tot, kk)
    if shard_mode in ("spatial", "tiles"):
        # the spatial and tiles layouts give inactive rows the sentinel
        # slot n_tot: they read the identities, as the mesh's masked
        # back-map gives them
        pvalid = perm < n_tot
        pc = torch.clamp(perm, 0, n_tot - 1)
        backed = torch.where(pvalid[None, :], stacked[:, pc],
                             _backed_neutral(reso, stacked.device))
        topk_tin = torch.where(pvalid[:, None], rows(ctin)[pc],
                               torch.full((), _BIG, device=ctin.device))
        topk_idx = torch.where(pvalid[:, None], rows(cidx)[pc],
                               torch.full((), _BIG_I, dtype=cidx.dtype,
                                          device=cidx.device))
        base = 0
    else:
        backed = take(stacked, perm.expand(stacked.shape[0], *perm.shape))
        base = 0
        if lead:    # the kernels' slot ids are global: back to the world's
            base = slot_base(x.worlds, x.nb, n_tot, cidx.device)
        topk_tin = take_rows(rows(ctin), perm)
        topk_idx = take_rows(rows(cidx - base), perm)
    if not resume:
        # sorted-space candidate ids to caller slots (the sentinel fill n
        # for an empty slot)
        topk_idx = take_ids(slot_inverse(perm, n, n_tot, fill=n),
                            torch.clamp(topk_idx, 0, n_tot).long())
    topk_idx = torch.where((topk_tin < _BIG) & (topk_idx < n_tot),
                           topk_idx, torch.full_like(topk_idx, -1))
    rd = RowConflictData(
        inconf=backed[0] > 0.5, tcpamax=backed[1],
        sum_dve=backed[2], sum_dvn=backed[3], sum_dvv=backed[4],
        tsolv=backed[5],
        # per-block float counts cast to int32 before summing: an f32
        # total loses exactness past 2^24 pairs
        nconf=ncnt.to(torch.int32).reshape(*lead, -1).sum(-1,
                                                           dtype=torch.int32),
        nlos=lcnt.to(torch.int32).reshape(*lead, -1).sum(-1,
                                                         dtype=torch.int32),
        topk_idx=topk_idx, topk_tin=topk_tin)
    nfix = 7 if resume else 6
    sw = tuple(backed[nfix:nfix + N_SWARM]) if reso == "swarm" else None
    if not resume:
        return (rd, sw) if sw is not None else rd
    merged = outs[11]
    merged = torch.where(merged >= 0, merged - base, merged)
    partners_new = merged.transpose(1, 2).reshape(*lead, n_tot, kk)
    if sw is not None:
        return rd, partners_new, backed[6] > 0.5, sw
    return rd, partners_new, backed[6] > 0.5
