"""Sparse segment-scheduled CD&R: near-physics-floor pair enumeration.

Port of the single-device replicate path of ``bluesky_tpu/ops/cd_sched.py``:

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
"""
from typing import NamedTuple

import numpy as np
import torch

from . import cd_pallas, cr_swarm
from .cd_pallas import _BIG, _FIELDS, _NF, N_SWARM, TileParams, launch_key
from .cd_tiled import (RowConflictData, block_reachability, precompute_trig,
                       take, take_ids, take_rows)
from . import geo

#: Launches of the CUDA kernel in each resolver form since the last reset.
LAUNCHES = {launch_key("cd_sched_tiles", r): 0 for r in cd_pallas.RESO_CODE}


def padded_size(n, block=256, extra=32):
    """Total slots of the padded stripe-sorted layout for n aircraft."""
    block = min(block, 256)
    return (-(-n // block) + extra) * block


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


def stripe_sort_dest(lat, lon, gs, active, thresh_m, block, extra):
    """Per-aircraft destination slots of the padded stripe-major layout
    (altitude layering off, as the sparse refresh runs it).  Inactive
    aircraft sort into the last stripe.  Divisions by constants are the
    products with the reciprocal that compiled JAX computes.  Columns
    with a leading world axis [W, n] (``thresh_m`` [W, 1]) sort each
    world on its own."""
    lead = lat.shape[:-1]
    n = lat.shape[-1]
    dev = lat.device
    act = active
    big = torch.full((), 1e9, dtype=lat.dtype, device=dev)
    any_act = act.any(-1, keepdim=True)
    latmin = torch.where(any_act,
                         torch.where(act, lat, big).amin(-1, keepdim=True),
                         torch.zeros((), dtype=lat.dtype, device=dev))
    latmax = torch.where(any_act,
                         torch.where(act, lat, -big).amax(-1, keepdim=True),
                         torch.ones((), dtype=lat.dtype, device=dev))
    span = torch.clamp_min(latmax - latmin, 1e-6)
    h = torch.clamp_min(torch.maximum(
        thresh_m * 1.05 * (1.0 / 110000.0),
        span * (1.0 / (extra - 1))), 0.05)
    s = torch.clamp(torch.floor((lat - latmin) / h), 0, extra - 2) \
        .to(torch.int32)
    s = torch.where(act, s, torch.full_like(s, extra - 1))
    qlon = torch.clamp((lon + 180.0) * (2 ** 19 / 360.0), 0, 2 ** 19 - 1)
    key = s * (2 ** 19) + qlon.to(torch.int32)
    order = torch.argsort(key, dim=-1, stable=True)    # sorted -> original
    ss = take(s, order).long()
    # a count by scatter_add, not bincount: on the card bincount reads
    # the largest index back to the host to size its output
    counts = torch.zeros((*lead, extra), dtype=torch.int64,
                         device=dev).scatter_add_(-1, ss, torch.ones_like(ss))
    nblocks = (counts + block - 1) // block
    zero = torch.zeros((*lead, 1), dtype=counts.dtype, device=dev)
    base = torch.cat([zero, torch.cumsum(nblocks, -1)[..., :-1]], -1) * block
    first = torch.cat([zero, torch.cumsum(counts, -1)[..., :-1]], -1)
    rank = torch.arange(n, device=dev) - take(first, ss)
    dest = torch.zeros((*lead, n), dtype=torch.int32, device=dev)
    return dest.scatter_(-1, order, (take(base, ss) + rank).to(torch.int32))


def scatter_padded(arrs, dest, n_tot, neutral=0.0):
    """Place per-aircraft columns into the padded sorted layout (per
    world, for columns with a leading world axis)."""
    idx = dest.long()
    out = []
    for a in arrs:
        z = torch.full((*a.shape[:-1], n_tot), neutral, dtype=a.dtype,
                       device=a.device)
        out.append(z.scatter_(-1, idx, a))
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


def sched_tiles_plain(packed, wst, wln, wmax, pold, p: TileParams,
                      reso="mvp", nbw=None):
    """Plain PyTorch version of the ``_sched_kernel`` pass: row block i
    walks its segments ``[wst[i, s], wst[i, s] + min(wln[i, s], wmax))``
    in slot order, blocks past the grid skipped.  Returns the 13
    outputs, 20 in the swarm form (see ``cd_pallas.row_block_plain``).
    With ``nbw`` the rows are a stack of worlds of ``nbw`` blocks each:
    the segments hold world-local blocks, past ``nbw`` skipped, and the
    slot ids and ``pold`` are global (``cd_pallas.full_grid_resume_plain``)."""
    nb, _, B = packed.shape
    nbw = nb if nbw is None else nbw
    st = wst.cpu().numpy()
    ln = np.minimum(wln.cpu().numpy(), wmax)

    def ids(i):
        t = [np.arange(b, b + k) for b, k in zip(st[i], ln[i]) if k > 0]
        t = np.concatenate(t) if t else np.zeros(0, np.int64)
        return cd_pallas.block_ids(t[t < nbw] + i // nbw * nbw, B)

    return cd_pallas.rows_plain(packed, pold, ids, p, reso)


def window_items(wst, wln, wmax, nbc, per_row=cd_pallas.ITEMS_PER_ROW):
    """``cd_pallas.work_items`` of the segment pass: row i's tiles are its
    segments' blocks ``[wst[i, s], wst[i, s] + min(wln[i, s], wmax))`` in
    segment order, blocks past the grid's ``nbc`` left out (ascending:
    ``build_windows`` gives disjoint segments in slot order).  A stack of
    worlds of ``nbc`` row blocks each ([W * nbc, s_cap] windows) offsets
    each row's tiles by its world's first block."""
    nb, s_cap = wst.shape
    t = torch.arange(wmax, dtype=torch.int64, device=wst.device)
    cand = wst.long()[:, :, None] + t
    valid = (t < torch.clamp(wln.long(), 0, wmax)[:, :, None]) & (cand < nbc)
    if nb != nbc:
        cand = cand + cd_pallas.world_base(nb, nbc, wst.device)[:, None, None]
    return cd_pallas.work_items(
        *cd_pallas.compact_rows(cand.reshape(nb, s_cap * wmax),
                                valid.reshape(nb, s_cap * wmax)), per_row)


def sched_tiles(packed, wst, wln, wmax, pold, p: TileParams,
                per_row=cd_pallas.ITEMS_PER_ROW, reso="mvp", nbw=None):
    """The segment pass: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see ``sched_tiles_plain``).  On the card each
    row's segment blocks are cut into at most ``per_row`` work items
    (``window_items``), walked by ``cd_sched_tiles`` and folded, with the
    partner merge, by ``cd_merge_items``; nothing waits for the device.
    A stack of worlds of ``nbw`` row blocks each is one launch of each
    kernel for the whole stack."""
    if not packed.is_cuda:
        return sched_tiles_plain(packed, wst, wln, wmax, pold, p, reso, nbw)
    from . import _cuda
    nb, B = cd_pallas.check_common(packed, pold, reso=reso)
    s_cap = wst.shape[1]
    _cuda.require(wst, torch.int32, (nb, s_cap), "wst")
    _cuda.require(wln, torch.int32, (nb, s_cap), "wln")
    items = window_items(wst, wln, int(wmax), nb if nbw is None else nbw,
                         per_row)
    parts = cd_pallas.walk_items(packed, items, p, pold, reso=reso)
    outs = cd_pallas.merge_items(parts, items, B, pold, reso)
    LAUNCHES[launch_key("cd_sched_tiles", reso)] += 1
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
    pold: torch.Tensor        # [W * nb, kk, B] int32 old partners
    perm: torch.Tensor        # [(W,) n] int32 caller slot -> padded slot
    n: int
    n_tot: int                # padded slots per world
    nb: int                   # row blocks per world
    block: int
    reso: str = "mvp"         # the tile body's resolver form
    worlds: int = 1


def prepare(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active, noreso,
            rpz, hpz, tlookahead, partners, block=256, s_cap=6, wmax=16,
            extra_blocks=32, perm=None, tas=None, cas=None,
            reso="mvp") -> SchedInputs:
    """Everything ``detect_resolve_sched`` hands the two kernels: the
    padded stripe-sorted slabs, the reachability, the segment windows and
    the partner table in kernel layout.  Always float32.  ``reso`` with
    ``tas`` (Eby) or ``cas`` (Swarm) fills the ``tr`` row
    (``cd_pallas.tr_row``); Swarm widens the reachability to its
    neighbourhood, horizontally and vertically.  Columns with a leading
    world axis [W, n] (``partners`` [W, n_tot, K] in world-local slots)
    give the stacked operands of every world (``SchedInputs``)."""
    lead = lat.shape[:-1]
    worlds = int(np.prod(lead, dtype=np.int64))
    n = lat.shape[-1]
    dtype = torch.float32
    block = min(block, 256)
    f = lambda a: a.to(dtype)
    if perm is None:
        thresh = reach_threshold_m(f(gs), active, float(tlookahead),
                                   float(rpz))
        perm = stripe_sort_dest(f(lat), f(lon), f(gs), active, thresh,
                                block, extra_blocks)
    nb = -(-n // block) + extra_blocks
    n_tot = nb * block
    cols = {"lat": lat, "lon": lon, "trk": trk, "gs": gs, "alt": alt,
            "vs": vs, "gse": gseast, "gsn": gsnorth,
            "tr": cd_pallas.tr_row(gs, {k: v for k, v in
                                        (("tas", tas), ("cas", cas))
                                        if v is not None}, reso),
            "active": active, "noreso": noreso}
    padded = dict(zip(cols, scatter_padded([f(v) for v in cols.values()],
                                           perm, n_tot)))
    fields = precompute_trig(padded["lat"], padded["lon"])
    trkrad = geo.radians(padded["trk"])
    fields.update({
        "u": padded["gs"] * torch.sin(trkrad),
        "v": padded["gs"] * torch.cos(trkrad),
        "alt": padded["alt"], "vs": padded["vs"], "gse": padded["gse"],
        "gsn": padded["gsn"], "trk": padded["trk"], "tr": padded["tr"],
        "active": padded["active"], "noreso": padded["noreso"]})
    packed = torch.stack([fields[k] for k in _FIELDS]).reshape(
        _NF, -1, block).transpose(0, 1).contiguous()
    swarm_m = ((cr_swarm.R_SWARM, cr_swarm.DH_SWARM) if reso == "swarm"
               else (0.0, 0.0))
    reach = block_reachability(
        padded["lat"], padded["lon"], padded["gs"], padded["active"] > 0.5,
        nb, block, float(rpz), float(tlookahead), alt=padded["alt"],
        vs=padded["vs"], hpz=float(hpz), min_reach_m=swarm_m[0],
        min_vreach_m=swarm_m[1])
    reach = reach.reshape(-1, nb)
    st, ln, overflow = build_windows(reach, s_cap, wmax, pad_start=nb)
    kk = partners.shape[-1]
    pold = partners.reshape(-1, block, kk).transpose(1, 2) \
        .to(torch.int32).contiguous()
    if lead:
        pold = torch.where(pold >= 0, pold + slot_base(worlds, nb, n_tot,
                                                       pold.device), pold)
    return SchedInputs(packed=packed, wst=torch.clamp(st, 0, nb), wln=ln,
                       wmax=wmax, overflow=overflow, reach=reach, pold=pold,
                       perm=perm, n=n, n_tot=n_tot, nb=nb, block=block,
                       reso=reso, worlds=worlds)


def slot_base(worlds, nb, n_tot, device):
    """[W * nb, 1, 1] int32: the first global slot of each row block's
    world (world w's slot s is ``w * n_tot + s``)."""
    return (torch.arange(worlds * nb, device=device, dtype=torch.int32)
            // nb * n_tot)[:, None, None]


def run_kernels(x: SchedInputs, p: TileParams):
    """The segment pass plus the overflow fallback in the resolver form
    ``x.reso``, merged row-disjointly (the 13 outputs in kernel layout,
    20 in the swarm form)."""
    outs_s = sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p,
                         reso=x.reso, nbw=x.nb)
    reach_f = x.reach & x.overflow[:, None]
    outs_f = cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p,
                                        reso=x.reso)
    rsel = x.overflow[:, None, None]
    return [torch.where(rsel, f, s) for f, s in zip(outs_f, outs_s)]


def detect_resolve_sched(lat, lon, trk, gs, alt, vs, gseast, gsnorth,
                         active, noreso, rpz, hpz, tlookahead, mvpcfg,
                         partners, resume_rpz_m, block=256, s_cap=6,
                         wmax=16, extra_blocks=32, perm=None, tas=None,
                         cas=None, reso="mvp"):
    """Sparse-scheduled CD&R with in-kernel resume-nav (the production
    form of the JAX function: ``partners`` given, one device).

    ``perm`` is the cached ``stripe_sort_dest`` table (recomputed when
    None); ``partners`` [n_tot, K] int32 is the sorted-space partner
    table.  ``reso`` is the resolver form of the pair sums, with ``tas``
    (Eby) or ``cas`` (Swarm).  Returns ``(rd, partners_new, active)``,
    and with ``reso="swarm"`` ``(rd, partners_new, active, swarm_sums)``:
    the per-ownship reductions in caller order (``rd.topk_*``
    sorted-space ids), the merged sorted-space partner table, the
    caller-space ASAS engagement flags and the seven neighbour sums in
    caller order.  The small-N delegate to the full-grid kernel and the
    mesh decompositions of the JAX function are not ported.

    Columns with a leading world axis [W, n] (``perm`` [W, n],
    ``partners`` [W, n_tot, K]) run W worlds in one interval, each kernel
    launched once for the stack; every result has the leading axis
    (``nconf``/``nlos`` [W]) and world-local slot ids."""
    x = prepare(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
                noreso, rpz, hpz, tlookahead, partners, block=block,
                s_cap=s_cap, wmax=wmax, extra_blocks=extra_blocks,
                perm=perm, tas=tas, cas=cas, reso=reso)
    p = cd_pallas.tile_params(rpz, hpz, tlookahead, mvpcfg, resume_rpz_m)
    outs = run_kernels(x, p)
    (inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt,
     ctin, cidx) = outs[:10]
    lead = lat.shape[:-1]
    n_tot, kk, perm = x.n_tot, partners.shape[-1], x.perm.long()
    stacked = torch.stack([o.reshape(*lead, n_tot) for o in
                           (inconf, tcpamax, sdve, sdvn, sdvv, tsolv,
                            *outs[12:])])
    backed = take(stacked, perm.expand(stacked.shape[0], *perm.shape))
    base = 0
    if lead:        # the kernels' slot ids are global: back to the world's
        base = slot_base(x.worlds, x.nb, n_tot, cidx.device)
    rows = lambda a: take_rows(a.transpose(1, 2).reshape(*lead, n_tot, kk),
                               perm)
    topk_tin = rows(ctin)
    topk_idx = rows(cidx - base)
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
    merged = outs[11]
    merged = torch.where(merged >= 0, merged - base, merged)
    partners_new = merged.transpose(1, 2).reshape(*lead, n_tot, kk)
    if reso == "swarm":
        return rd, partners_new, backed[6] > 0.5, \
            tuple(backed[7:7 + N_SWARM])
    return rd, partners_new, backed[6] > 0.5
