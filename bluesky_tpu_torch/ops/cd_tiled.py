"""Blockwise conflict detection and MVP accumulation on tensors.

Port of ``bluesky_tpu/ops/cd_tiled.py``: the per-aircraft trig columns,
the delta-polynomial pair geometry of one tile (``tile_geometry``, which
the plain tile bodies and the CUDA kernels compute identically), the
exact block reachability bound, the Morton slot order with its
sorted-space runner (``spatial_permutation``, ``run_spatially_sorted``),
the host-side partner-table resume-nav (``topk_partners``,
``partner_keep``, ``merge_partners``) and ``detect_resolve_tiled``, the
CD&R of ``SimConfig(cd_backend="tiled")`` with the pair sums of MVP,
Eby or MVP plus the Swarm neighbour sums.

The JAX ``detect_resolve_tiled`` is a ``lax.scan`` over column blocks
with a ``lax.cond`` skip per tile, compiled into one program.  Eager
PyTorch pays a launch per operation, so a tile-by-tile loop would cost
~100 launches per tile (millions per interval at 100k aircraft).  Here
the ``[nb, nb]`` block reachability is read to the host once per call,
and each row block meets the slabs of all its reachable column blocks at
once: the per-pair formulas of the JAX tile on ``[B, nc * B]`` operands,
one eager iteration per row block, no host sync inside the loop.  No
kernel: the JAX function reaches no Pallas kernel either.
"""
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import cr_eby, cr_mvp, cr_swarm, geo, kmath


class RowConflictData(NamedTuple):
    """Per-ownship reductions of the pair space — no [N, N] anywhere."""
    inconf: torch.Tensor     # [N] bool
    tcpamax: torch.Tensor    # [N]
    sum_dve: torch.Tensor    # [N]
    sum_dvn: torch.Tensor    # [N]
    sum_dvv: torch.Tensor    # [N]
    tsolv: torch.Tensor      # [N]  min vertical solve time (1e9 = none)
    nconf: torch.Tensor      # scalar int32
    nlos: torch.Tensor       # scalar int32
    topk_idx: torch.Tensor   # [N, K] int32
    topk_tin: torch.Tensor   # [N, K]


def _pad1(a, npad, value):
    return a if npad == 0 else torch.cat([a, a.new_full((npad,), value)])


#: per-aircraft columns consumed by tile_geometry, in slab order
TRIG_FIELDS = ("lat", "lon", "sl", "cl", "rloc", "abslat")


def precompute_trig(lat, lon):
    """Per-aircraft trig/radius columns for the factored pair geometry."""
    rlat = geo.radians(lat)
    return {"lat": lat, "lon": lon, "sl": torch.sin(rlat),
            "cl": torch.cos(rlat), "rloc": geo.rwgs84(lat),
            "abslat": torch.abs(lat)}


def _rwgs84_from_trig(cosphi, sinphi):
    """geo.rwgs84 from cos/sin of the latitude angle (sqrt * rsqrt)."""
    an = geo.A_WGS84 * geo.A_WGS84 * cosphi
    bn = geo.B_WGS84 * geo.B_WGS84 * sinphi
    ad = geo.A_WGS84 * cosphi
    bd = geo.B_WGS84 * sinphi
    return torch.sqrt(an * an + bn * bn) * torch.rsqrt(ad * ad + bd * bd)


def _sin_poly(x):
    """sin(x) as a degree-7 odd Taylor evaluation, |x| <= pi.  The JAX
    function divides by 6, 20 and 42; compiled, XLA multiplies by the
    reciprocals in the operand's dtype, and so does this one."""
    x2 = x * x
    return x * (1.0 - x2 * (1.0 / 6.0) * (1.0 - x2 * (1.0 / 20.0)
                                          * (1.0 - x2 * (1.0 / 42.0))))


def tile_geometry(own, intr):
    """Pair distance [m] + bearing sin/cos between broadcast-shaped
    ownship and intruder TRIG_FIELDS columns (the general branch of the
    JAX function, which is bit-identical to its same-hemisphere variant
    on same-hemisphere pairs).  Returns (dist, sin_qdr, cos_qdr)."""
    sl_o, cl_o = own["sl"], own["cl"]
    sl_i, cl_i = intr["sl"], intr["cl"]
    cos_sum = cl_o * cl_i - sl_o * sl_i
    sin_sum = sl_o * cl_i + cl_o * sl_i
    res1 = _rwgs84_from_trig(cos_sum, sin_sum)
    eps = torch.where(own["lat"] == 0.0, 1e-6, 0.0).to(own["lat"].dtype)
    denom = own["abslat"] + intr["abslat"] + eps
    res2 = 0.5 * (own["abslat"] * (own["rloc"] + geo.A_WGS84)
                  + intr["abslat"] * (intr["rloc"] + geo.A_WGS84)) / denom
    r = torch.where(own["lat"] * intr["lat"] < 0.0, res2, res1)

    dlat = geo.radians(intr["lat"] - own["lat"])
    dlon_deg = intr["lon"] - own["lon"]
    dlon = geo.radians(dlon_deg - 360.0 * torch.round(dlon_deg * (1.0 / 360.0)))
    sh_lat = _sin_poly(0.5 * dlat)
    sh_lon = _sin_poly(0.5 * dlon)
    root = sh_lat * sh_lat + cl_o * cl_i * sh_lon * sh_lon
    root = torch.clamp(root, 0.0, 1.0)
    dist = 2.0 * r * kmath.asin_taylor(torch.sqrt(root))
    qy = _sin_poly(dlon) * cl_i
    qx = _sin_poly(dlat) + sl_o * cl_i * (2.0 * sh_lon * sh_lon)
    rh = torch.rsqrt(torch.clamp_min(qx * qx + qy * qy, 1e-37))
    return dist, qy * rh, qx * rh


def _spread15(x):
    """Spread the low 15 bits of int64 ``x`` to the even bit positions
    (the Morton bit trick, in int64: uint32 shifts are not supported on
    every PyTorch device)."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def spatial_permutation(lat, lon, active):
    """[N] int64 permutation (sorted position -> caller slot) ordering
    aircraft along a Morton curve of 15-bit quantized lat/lon; inactive
    slots sort last.  The quantization runs in the input's dtype as
    compiled JAX computes ``(lat + 90) / 180 * 32767``: XLA folds the two
    constants into one product.  The sort is stable, like
    ``jnp.argsort``, so colliding codes keep slot order."""
    qlat = torch.clamp((lat + 90.0) * (32767.0 / 180.0), 0, 32767)
    qlon = torch.clamp((lon + 180.0) * (32767.0 / 360.0), 0, 32767)
    code = _spread15(qlat.to(torch.int64)) \
        | (_spread15(qlon.to(torch.int64)) << 1)
    key = torch.where(active, code, torch.full_like(code, 0x7FFFFFFF))
    return torch.argsort(key, stable=True)


def take(a, idx):
    """``a[..., idx]`` row by row: ``a`` [..., n] gathered by ``idx``
    [..., m] along the last axis (``a[idx]`` for one world)."""
    return a[idx] if a.ndim == 1 else torch.gather(a, -1, idx)


def take_ids(a, ids):
    """``a[..., ids]`` for an id table ``ids`` [..., n, K] and a lookup
    ``a`` [..., m], per world."""
    return take(a, ids.reshape(*ids.shape[:-2], -1)).reshape(ids.shape)


def take_rows(a, idx):
    """The rows ``idx`` [..., m] of ``a`` [..., n, k], per world."""
    if a.ndim == 2:
        return a[idx]
    return torch.gather(a, -2, idx[..., None].expand(*idx.shape, a.shape[-1]))


def invert(perm):
    """The inverse of a permutation ``perm`` [..., n] (per world), by
    scatter: an O(N) store instead of a second sort."""
    ar = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, ar)


def run_spatially_sorted(kernel, lat, lon, trk, gs, alt, vs, gseast,
                         gsnorth, active, noreso, *args, perm=None,
                         extra_cols=None, **kw):
    """Run a CD&R function in Morton-sorted slot space and map its
    ``RowConflictData`` back to caller order: rows by the inverse
    permutation, partner ids through ``perm`` (they are sorted-space
    positions).  ``extra_cols`` (per-aircraft columns by name) are
    permuted too; a ``(rd, swarm_sums)`` result maps its sums back as
    rows.  ``perm`` [N] (sorted position -> caller slot) may be a stale
    cached permutation: any permutation is exact, since the
    reachability is recomputed from the true positions.  Columns with a
    leading world axis [W, N] sort each world by its own ``perm``."""
    if perm is None:
        perm = spatial_permutation(lat, lon, active)
    perm = perm.long()
    inv = invert(perm)
    g = lambda a: take(a, perm)
    if extra_cols:
        kw = dict(kw, extra_cols={k: g(v) for k, v in extra_cols.items()})
    rd = kernel(g(lat), g(lon), g(trk), g(gs), g(alt), g(vs), g(gseast),
                g(gsnorth), g(active), g(noreso), *args, **kw)
    extra = None
    if not isinstance(rd, RowConflictData):        # (rd, swarm_sums)
        rd, extra = rd
    back = lambda a: take(a, inv)
    idx = torch.clamp_min(rd.topk_idx, 0).long()
    topk_idx = torch.where(rd.topk_idx >= 0,
                           take_ids(perm, idx).to(torch.int32),
                           torch.full_like(rd.topk_idx, -1))
    rd = RowConflictData(
        inconf=back(rd.inconf), tcpamax=back(rd.tcpamax),
        sum_dve=back(rd.sum_dve), sum_dvn=back(rd.sum_dvn),
        sum_dvv=back(rd.sum_dvv), tsolv=back(rd.tsolv),
        nconf=rd.nconf, nlos=rd.nlos,
        topk_idx=take_rows(topk_idx, inv),
        topk_tin=take_rows(rd.topk_tin, inv))
    if extra is not None:
        return rd, tuple(back(a) for a in extra)
    return rd


def topk_partners(rd, k):
    """The [N, K] partner candidates of a ``RowConflictData`` (-1 empty),
    already in urgency order, cropped or padded to the table width K."""
    idx = rd.topk_idx[:, :k]
    pad = k - idx.shape[1]
    if pad > 0:
        idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), -1)], 1)
    return idx


def partner_keep(partners, lat, lon, gseast, gsnorth, trk, active, rpz,
                 rpz_m):
    """Resume-nav keep mask [N, K] of the partner table (reference
    asas.py:426-455) on the gathered partner state."""
    n = lat.shape[0]
    valid = partners >= 0
    j = torch.clamp(partners, 0, n - 1).long()
    dist_e, dist_n = cr_mvp.resume_displacement(
        lat[:, None], lon[:, None], lat[j], lon[j])
    vrel_e = gseast[j] - gseast[:, None]
    vrel_n = gsnorth[j] - gsnorth[:, None]
    alive = active[:, None] & active[j]
    keep = cr_mvp.resume_keep_core(dist_e, dist_n, vrel_e, vrel_n,
                                   trk[:, None], trk[j], alive, rpz, rpz_m)
    return keep & valid


def merge_partners(new_idx, old_idx, old_keep):
    """New [N, K] partner table: the fresh partners ``new_idx`` (most
    urgent first, -1 empty) first, then the old partners surviving
    ``old_keep`` in slot order, duplicates of fresh ones dropped."""
    k = new_idx.shape[1]
    old = torch.where(old_keep, old_idx, torch.full_like(old_idx, -1))
    dup = ((old[:, :, None] == new_idx[:, None, :])
           & (new_idx[:, None, :] >= 0)).any(2)
    old = torch.where(dup, torch.full_like(old, -1), old)
    cat = torch.cat([new_idx, old], 1)                    # [N, 2K]
    pos = torch.arange(2 * k, device=cat.device)[None, :]
    key = torch.where(cat >= 0, pos, 2 * k + pos)         # valid first
    order = torch.argsort(key, dim=1, stable=True)[:, :k]
    return torch.gather(cat, 1, order)


def block_summaries(lat, lon, gs, active, nb, block, alt=None, vs=None):
    """Per-block active-aircraft summaries the reachability bound reads
    (a leading world axis gives [W, nb] summaries)."""
    shape = (*lat.shape[:-1], nb, block)
    blat, blon, bgs = lat.reshape(shape), lon.reshape(shape), gs.reshape(shape)
    act = active.reshape(shape)
    inf = torch.full((), float("inf"), dtype=lat.dtype, device=lat.device)
    zero = torch.zeros((), dtype=lat.dtype, device=lat.device)
    out = dict(
        latmin=torch.where(act, blat, inf).amin(-1),
        latmax=torch.where(act, blat, -inf).amax(-1),
        lonmin=torch.where(act, blon, inf).amin(-1),
        lonmax=torch.where(act, blon, -inf).amax(-1),
        gsmax=torch.where(act, bgs, zero).amax(-1))
    if alt is not None:
        balt = alt.reshape(shape)
        bvs = torch.abs(vs.reshape(shape))
        out.update(altmin=torch.where(act, balt, inf).amin(-1),
                   altmax=torch.where(act, balt, -inf).amax(-1),
                   vsmax=torch.where(act, bvs, zero).amax(-1))
    return out


def reachability_from_summaries(row, col, rpz, tlookahead, hpz=None,
                                min_reach_m=0.0, min_vreach_m=0.0,
                                margin_m=0.0):
    """[nbr, nbc] bool reachability between two summary sets ([W, nbr,
    nbc] for summaries with a leading world axis): a shard's own rows
    against the gathered columns in the spatial and tiles modes.
    ``margin_m`` widens the horizontal bound (the shard refreshes' drift
    allowance)."""
    r = lambda x: x[..., :, None]          # row summaries down the rows
    c = lambda x: x[..., None, :]          # column summaries across
    latmin_r, latmax_r = row["latmin"], row["latmax"]
    latmin_c, latmax_c = col["latmin"], col["latmax"]
    maxabslat_r = torch.maximum(torch.abs(latmin_r), torch.abs(latmax_r))
    maxabslat_c = torch.maximum(torch.abs(latmin_c), torch.abs(latmax_c))
    dlat_gap = torch.clamp_min(torch.maximum(
        r(latmin_r) - c(latmax_c), c(latmin_c) - r(latmax_r)), 0.0)
    lin_gap = torch.clamp_min(torch.maximum(
        r(row["lonmin"]) - c(col["lonmax"]),
        c(col["lonmin"]) - r(row["lonmax"])), 0.0)
    wrap_gap = torch.clamp_min(360.0 - (
        torch.maximum(r(row["lonmax"]), c(col["lonmax"]))
        - torch.minimum(r(row["lonmin"]), c(col["lonmin"]))), 0.0)
    dlon_gap = torch.minimum(lin_gap, wrap_gap)
    cos_lb = torch.cos(geo.radians(torch.clamp_max(
        torch.maximum(r(maxabslat_r), c(maxabslat_c)), 90.0)))
    r_min = 6335000.0
    zonal = 2.0 * r_min * torch.asin(torch.clamp(
        cos_lb * torch.sin(geo.radians(0.5 * torch.clamp_max(dlon_gap, 360.0))),
        0.0, 1.0))
    merid = dlat_gap * 110000.0
    dist_lb = torch.maximum(merid, zonal)
    thresh = rpz + tlookahead * (r(row["gsmax"]) + c(col["gsmax"]))
    thresh = torch.clamp_min(thresh, min_reach_m)
    if torch.is_tensor(margin_m) or margin_m:
        thresh = thresh + margin_m
    reach = dist_lb <= thresh * 1.05
    if hpz is not None and "altmin" in row:
        altgap = torch.clamp_min(torch.maximum(
            r(row["altmin"]) - c(col["altmax"]),
            c(col["altmin"]) - r(row["altmax"])), 0.0)
        vthresh = hpz + tlookahead * (r(row["vsmax"]) + c(col["vsmax"]))
        vthresh = torch.clamp_min(vthresh, min_vreach_m)
        reach = reach & (altgap <= vthresh * 1.05)
    return reach


def block_reachability(lat, lon, gs, active, nb, block, rpz, tlookahead,
                       alt=None, vs=None, hpz=None, min_reach_m=0.0,
                       min_vreach_m=0.0):
    """[nb, nb] bool: which block pairs can possibly contain a conflict
    or LoS (the exact horizontal and vertical skip bounds), or, with
    ``min_reach_m`` / ``min_vreach_m``, a pair that near (the Swarm
    neighbourhood).  Columns with a leading world axis [W, nb * block]
    give each world's [W, nb, nb]."""
    summ = block_summaries(lat, lon, gs, active, nb, block, alt=alt, vs=vs)
    return reachability_from_summaries(summ, summ, rpz, tlookahead,
                                       hpz=hpz if alt is not None else None,
                                       min_reach_m=min_reach_m,
                                       min_vreach_m=min_vreach_m)


#: reachable tiles and eager row iterations of the last
#: ``detect_resolve_tiled`` call (host counts, read by ``chip_smoke.py``)
LAST_CALL = {"tiles": 0, "iterations": 0, "nb": 0}


def _first_k(urg, kk):
    """The ``kk`` smallest entries of each row of ``urg`` [B, C] in
    (value, column) order, ties to the lower column, as the JAX
    per-tile ``lax.top_k`` merged tile by tile in ascending column order
    selects them.  ``torch.topk`` gives the values but no tie order, so
    the ties at the k-th value are taken by column rank.  Returns
    ``(values [B, kk], columns [B, kk])``."""
    C = urg.shape[1]
    kth = torch.topk(urg, kk, dim=1, largest=False).values.amax(1, keepdim=True)
    below = urg < kth
    at = urg == kth
    need = kk - below.sum(1, keepdim=True)
    take = below | (at & (torch.cumsum(at, 1) <= need))
    pos = torch.arange(C, device=urg.device).expand_as(urg)
    cols = torch.topk(torch.where(take, pos, C), kk, dim=1,
                      largest=False, sorted=True).values
    vals, order = torch.sort(torch.gather(urg, 1, cols), dim=1, stable=True)
    return vals, torch.gather(cols, 1, order)


def detect_resolve_tiled(lat, lon, trk, gs, alt, vs, gseast, gsnorth,
                         active, noreso, rpz, hpz, tlookahead, mvpcfg,
                         block=512, k_partners=8, prefilter=True,
                         spatial_sort=True, perm=None, extra_cols=None,
                         reso="mvp"):
    """One pass over all aircraft pairs in [block, block] tiles, the
    resolver's pair sums accumulated per ownship (reference
    StateBasedCD.py:7-103, MVP.py:14-143, Eby.py:73-138, Swarm.py:47-66;
    JAX ``cd_tiled.py:402-659``).  Arguments as ``cd.detect`` plus the
    MVP inputs; returns a ``RowConflictData``, and with
    ``reso="swarm"`` ``(rd, swarm_sums)``: the seven neighbour sums of
    ``cr_swarm.resolve_from_sums``.

    ``reso="eby"`` replaces the MVP sums by the Eby sums on the TAS
    velocities of ``extra_cols["tas"]`` (no noreso mask, ``tsolv`` left
    at 1e9); ``reso="swarm"`` keeps the MVP sums, adds the neighbour sums
    with the CAS of ``extra_cols["cas"]`` and widens the reachability to
    the swarm radius.  ``prefilter`` skips the tiles the exact block
    reachability bound rules out; ``spatial_sort`` runs in the Morton
    order ``perm`` (sorted position -> caller slot; computed when None).
    The partner candidates are the ``min(k_partners, block)`` smallest
    entry times of each row, ties to the lower sorted-space column, as
    the JAX scan's running top-K selects them."""
    n = lat.shape[0]
    if spatial_sort and n > block:
        return run_spatially_sorted(
            functools.partial(detect_resolve_tiled, block=block,
                              k_partners=k_partners, prefilter=prefilter,
                              spatial_sort=False, reso=reso),
            lat, lon, trk, gs, alt, vs, gseast, gsnorth, active, noreso,
            rpz, hpz, tlookahead, mvpcfg, perm=perm, extra_cols=extra_cols)
    block = min(block, max(n, 1))
    kk = min(k_partners, block)
    nb = -(-n // block)
    # One tile caps the candidates at block = n exactly (at most n - 1
    # partners exist); across tiles fewer than K a tile would drop some.
    if nb > 1 and block < k_partners:
        raise ValueError(
            f"block ({block}) must be >= k_partners ({k_partners}) "
            "when the pair space spans multiple tiles")
    npad = nb * block - n
    dtype, dev = lat.dtype, lat.device
    nt = nb * block

    trkrad = geo.radians(_pad1(trk, npad, 0.0))
    gsp = _pad1(gs, npad, 0.0)
    cols = precompute_trig(_pad1(lat, npad, 0.0), _pad1(lon, npad, 0.0))
    cols.update(alt=_pad1(alt, npad, 0.0), vs=_pad1(vs, npad, 0.0),
                gse=_pad1(gseast, npad, 0.0), gsn=_pad1(gsnorth, npad, 0.0),
                u=gsp * torch.sin(trkrad), v=gsp * torch.cos(trkrad))
    extra_cols = extra_cols or {}
    if reso == "eby":
        # the exact TAS velocity columns
        tas = _pad1(extra_cols.get("tas", gs), npad, 0.0)
        cols.update(ute=tas * torch.sin(trkrad), utn=tas * torch.cos(trkrad))
    elif reso == "swarm":
        cols.update(trk=_pad1(trk, npad, 0.0),
                    cas=_pad1(extra_cols.get("cas", gs), npad, 0.0))
    names = tuple(cols)
    slab = torch.stack([cols[k] for k in names])             # [F, nt]
    act = _pad1(active, npad, False)
    nor = _pad1(noreso, npad, False)

    if prefilter:
        # Swarm widens the bound to its neighbourhood, so that a short
        # lookahead cannot skip a swarm neighbour
        reach = block_reachability(
            cols["lat"], cols["lon"], gsp, act, nb, block, rpz, tlookahead,
            min_reach_m=cr_swarm.R_SWARM if reso == "swarm" else 0.0)
        reach_h = reach.cpu().numpy()             # the one host sync
    else:
        reach_h = np.ones((nb, nb), bool)
    rows = [np.flatnonzero(r) for r in reach_h]
    starts = np.cumsum([0] + [len(r) for r in rows])
    blocks_dev = torch.as_tensor(np.concatenate(rows + [np.zeros(0, np.int64)]),
                                 dtype=torch.int64, device=dev)
    LAST_CALL.update(tiles=int(starts[-1]), nb=nb,
                     iterations=int(sum(len(r) > 0 for r in rows)))

    big = 1e9
    zero = torch.zeros((), dtype=dtype, device=dev)
    inconf = torch.zeros(nt, dtype=torch.bool, device=dev)
    tcpamax = torch.zeros(nt, dtype=dtype, device=dev)
    sums = torch.zeros((3, nt), dtype=dtype, device=dev)
    tsolv = torch.full((nt,), big, dtype=dtype, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    swarm = torch.zeros((7, nt), dtype=dtype, device=dev)
    topk_tin = torch.full((nt, kk), big, dtype=dtype, device=dev)
    topk_idx = torch.full((nt, kk), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(block, device=dev)
    r2 = rpz * rpz
    for ri in range(nb):
        if starts[ri] == starts[ri + 1]:
            continue
        rs = slice(ri * block, (ri + 1) * block)
        ids = (blocks_dev[starts[ri]:starts[ri + 1], None] * block
               + lane).reshape(-1)                           # [C]
        o = {k: slab[j, rs][:, None] for j, k in enumerate(names)}
        c_all = slab[:, ids]
        c = {k: c_all[j][None, :] for j, k in enumerate(names)}

        pairmask = (act[rs][:, None] & act[ids][None, :]
                    & ((ri * block + lane)[:, None] != ids[None, :]))
        excl = torch.where(pairmask, zero, zero + big)
        dist0, sinqdr, cosqdr = tile_geometry(o, c)
        dist = dist0 + excl
        dx = dist * sinqdr
        dy = dist * cosqdr
        du = c["u"] - o["u"]
        dv = c["v"] - o["v"]
        dv2 = du * du + dv * dv
        dv2 = torch.where(torch.abs(dv2) < 1e-6, zero + 1e-6, dv2)
        rvrel = torch.rsqrt(dv2)
        tcpa = -(du * dx + dv * dy) * (rvrel * rvrel) + excl
        dcpa2 = dist * dist - tcpa * tcpa * dv2
        swhorconf = dcpa2 < r2
        dtinhor = torch.sqrt(torch.clamp_min(r2 - dcpa2, 0.0)) * rvrel
        tinhor = torch.where(swhorconf, tcpa - dtinhor, zero + 1e8)
        touthor = torch.where(swhorconf, tcpa + dtinhor, zero - 1e8)

        drel_v = c["alt"] - o["alt"]
        dalt = drel_v + excl
        vrel_v = c["vs"] - o["vs"]
        dvs = torch.where(torch.abs(vrel_v) < 1e-6, zero + 1e-6, vrel_v)
        nrdvs = torch.div(zero - 1.0, dvs)    # one divide for both
        tcrosshi = (dalt + hpz) * nrdvs
        tcrosslo = (dalt - hpz) * nrdvs
        tinconf = torch.maximum(torch.minimum(tcrosshi, tcrosslo), tinhor)
        toutconf = torch.minimum(torch.maximum(tcrosshi, tcrosslo), touthor)
        swconfl = (swhorconf & (tinconf <= toutconf) & (toutconf > 0.0)
                   & (tinconf < tlookahead) & pairmask)
        swlos = (dist < rpz) & (torch.abs(dalt) < hpz) & pairmask

        if reso == "eby":
            dve_p, dvn_p, dvv_p = cr_eby.pair_contrib(
                dx, dy, drel_v, c["ute"] - o["ute"], c["utn"] - o["utn"],
                vrel_v, mvpcfg.rpz_m)
            tsolv_p = torch.full_like(dve_p, big)
            mvpmask = swconfl               # Eby has no noreso mask
        else:
            dve_p, dvn_p, dvv_p, tsolv_p = cr_mvp.pair_contrib_trig(
                sinqdr, cosqdr, dist, tcpa, tinconf, drel_v,
                c["gse"] - o["gse"], c["gsn"] - o["gsn"], vrel_v, mvpcfg)
            mvpmask = swconfl & ~nor[ids][None, :]
        if reso == "swarm":
            dtrk = cr_swarm.wrap_track(c["trk"] - o["trk"])
            w = cr_swarm.pair_weight(dx, dy, drel_v, dtrk,
                                     pairmask).to(dtype)
            swarm[:, rs] = torch.stack([
                w.sum(1), (w * c["cas"]).sum(1), (w * c["vs"]).sum(1),
                (w * dtrk).sum(1), (w * dx).sum(1), (w * dy).sum(1),
                (w * c["alt"]).sum(1)])

        inconf[rs] = swconfl.any(1)
        tcpamax[rs] = torch.clamp_min((tcpa * swconfl).amax(1), 0.0)
        # a masked pair adds 0, even where its displacement is not finite
        sums[:, rs] = torch.stack([torch.where(mvpmask, x, zero).sum(1)
                                   for x in (dve_p, dvn_p, dvv_p)])
        tsolv[rs] = torch.where(mvpmask, tsolv_p, zero + big).amin(1)
        counts += torch.stack([swconfl.sum(), swlos.sum()])
        vals, at = _first_k(torch.where(swconfl, tinconf, zero + big), kk)
        topk_tin[rs] = vals
        topk_idx[rs] = ids[at].to(torch.int32)

    topk_idx = torch.where(topk_tin < big, topk_idx,
                           torch.full_like(topk_idx, -1))
    counts = counts.to(torch.int32)
    rd = RowConflictData(
        inconf=inconf[:n], tcpamax=tcpamax[:n], sum_dve=sums[0, :n],
        sum_dvn=sums[1, :n], sum_dvv=sums[2, :n], tsolv=tsolv[:n],
        nconf=counts[0], nlos=counts[1], topk_idx=topk_idx[:n],
        topk_tin=topk_tin[:n])
    if reso == "swarm":
        return rd, tuple(swarm[:, :n])
    return rd
