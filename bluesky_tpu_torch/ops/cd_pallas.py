"""Fused blockwise CD&R tile body and the full-grid resume pass.

Port of the parts of ``bluesky_tpu/ops/cd_pallas.py`` the sparse
scheduler runs: the packed slab layout (``_FIELDS``), the per-pair tile
body with the resume keep predicate (``_tile_pairs``), the partner merge
(``_merge_partners_block``) and ``full_grid_pass`` in its resume form,
which the scheduler uses as its exact fallback for overflow rows.

The TPU kernel ``_kernel_resume`` becomes the hand-written CUDA kernel
``cd_full_grid_resume`` of ``csrc/cd_tiles.cu`` (one CTA per ownship row
block, one thread per ownship).  ``full_grid_resume_plain`` computes the
same function with plain PyTorch on any device; ``full_grid_resume``
launches the kernel for CUDA tensors and runs the plain version only for
CPU tensors.

Both this module's plain version and the kernel visit a row's tiles in
ascending intruder-block order and break top-K ties towards the smaller
intruder id, which is exactly the Pallas extraction order (smallest
``tinconf`` first, ties to the smaller id, earlier tiles win across
tiles).  Masked pairs (inactive, self) are left out instead of being
pushed out of range with ``_BIG``.
"""
from typing import NamedTuple

import numpy as np
import torch

from . import cr_mvp, geo
from .cd_tiled import TRIG_FIELDS, tile_geometry

# Packed slab rows of the [nb, 16, block] arrays.  The "tr" row is
# overloaded per resolver (tas/gs ratio for Eby, cas for Swarm); MVP
# never reads it and the contract keeps it at 16 rows.
_FIELDS = TRIG_FIELDS + ("u", "v", "alt", "vs", "gse", "gsn", "trk",
                         "tr", "active", "noreso")
_NF = len(_FIELDS)
_IDX = {k: i for i, k in enumerate(_FIELDS)}
_BIG = 1e9
_BIG_I = 2 ** 30
#: Partner-table width K (columns of ``partners_s``), fixed by the kernels.
KK = 8

#: Identity elements of the 10 accumulator outputs, in output order:
#: inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt, ctin, cidx.
_ACC_NEUTRAL = (0.0, 0.0, 0.0, 0.0, 0.0, _BIG, 0.0, 0.0, _BIG, _BIG_I)

#: Launches of the CUDA kernel since the last reset (plain versions and
#: CPU calls do not count).
LAUNCHES = {"cd_full_grid_resume": 0}


class TileParams(NamedTuple):
    """Scalar parameters of the tile body (host floats; the kernel and
    the plain version both round them to f32)."""
    rpz: float            # [m] protected-zone radius
    hpz: float            # [m] protected-zone half-height
    tlookahead: float     # [s]
    rpz_m: float          # [m] MVP zone radius with margin
    hpz_m: float          # [m] MVP half-height with margin
    tlook_m: float        # [s] MVP lookahead
    rpz_resume: float     # [m] resume-nav bouncing radius rpz * resofach


def tile_params(rpz, hpz, tlookahead, mvpcfg, resume_rpz_m) -> TileParams:
    return TileParams(float(rpz), float(hpz), float(tlookahead),
                      float(mvpcfg.rpz_m), float(mvpcfg.hpz_m),
                      float(mvpcfg.tlookahead), float(resume_rpz_m))


def _rdiv(c, t):
    """``c / t`` as one correctly rounded division (a Python scalar
    divided by a tensor would otherwise become reciprocal-then-multiply,
    two roundings), as the kernel and the JAX reference compute it."""
    return torch.div(t.new_tensor(c), t)


def row_block_plain(own, intr, gid_own, gid_int, pold, p: TileParams):
    """One ownship row block against its visited intruder tiles.

    ``own`` [_NF, B] ownship slab; ``intr`` [_NF, M] the visited
    intruders in visiting order (ascending block, then lane) with their
    global slot ids ``gid_int`` [M]; ``gid_own`` [B]; ``pold`` [kk, B]
    the old partner table (sorted-space ids, -1 empty).  Returns the 13
    per-row outputs of the kernel: eight [B] accumulators, ctin/cidx/
    keep/merged [kk, B] and active [B]."""
    kk = pold.shape[0]
    B = own.shape[1]
    if intr.shape[1] < kk:
        # pad with inactive intruders so every reduction and the top-kk
        # have at least kk rows to work on
        pad = kk - intr.shape[1]
        intr = torch.cat([intr, intr.new_zeros((_NF, pad))], 1)
        gid_int = torch.cat([gid_int, gid_int.new_full((pad,), _BIG_I)])
    o = lambda k: own[_IDX[k]][None, :]                  # [1, B]
    i = lambda k: intr[_IDX[k]][:, None]                 # [M, 1]
    pairmask = ((o("active") > 0.5) & (i("active") > 0.5)
                & (gid_own[None, :] != gid_int[:, None]))

    dist, sinq, cosq = tile_geometry({k: o(k) for k in TRIG_FIELDS},
                                     {k: i(k) for k in TRIG_FIELDS})
    dx = dist * sinq
    dy = dist * cosq
    du = i("u") - o("u")
    dv = i("v") - o("v")
    dv2 = du * du + dv * dv
    dv2 = torch.where(torch.abs(dv2) < 1e-6, torch.full_like(dv2, 1e-6), dv2)
    rvrel = torch.rsqrt(dv2)
    tcpa = -(du * dx + dv * dy) * (rvrel * rvrel)
    dcpa2 = dist * dist - tcpa * tcpa * dv2
    r2 = p.rpz * p.rpz
    swhor = dcpa2 < r2
    dtinhor = torch.sqrt(torch.clamp_min(r2 - dcpa2, 0.0)) * rvrel
    tinhor = torch.where(swhor, tcpa - dtinhor, torch.full_like(tcpa, 1e8))
    touthor = torch.where(swhor, tcpa + dtinhor, torch.full_like(tcpa, -1e8))
    dalt = i("alt") - o("alt")
    vrel_v = i("vs") - o("vs")
    dvs = torch.where(torch.abs(vrel_v) < 1e-6,
                      torch.full_like(vrel_v, 1e-6), vrel_v)
    nrdvs = _rdiv(-1.0, dvs)
    tcrosshi = (dalt + p.hpz) * nrdvs
    tcrosslo = (dalt - p.hpz) * nrdvs
    tinconf = torch.maximum(torch.minimum(tcrosshi, tcrosslo), tinhor)
    toutconf = torch.minimum(torch.maximum(tcrosshi, tcrosslo), touthor)
    swconfl = (swhor & (tinconf <= toutconf) & (toutconf > 0.0)
               & (tinconf < p.tlookahead) & pairmask)
    swlos = (dist < p.rpz) & (torch.abs(dalt) < p.hpz) & pairmask
    vrel_e = i("gse") - o("gse")
    vrel_n = i("gsn") - o("gsn")

    mvp = cr_mvp.MVPConfig(rpz_m=p.rpz_m, hpz_m=p.hpz_m,
                           tlookahead=p.tlook_m)
    dve_p, dvn_p, dvv_p, tsolv_p = cr_mvp.pair_contrib_trig(
        sinq, cosq, dist, tcpa, tinconf, dalt, vrel_e, vrel_n, vrel_v, mvp)
    mvpmask = swconfl & ~(i("noreso") > 0.5)
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)

    def colsum(x, m):
        return torch.where(m, x, zero).sum(0)

    inconf = swconfl.any(0).to(dist.dtype)
    tcpamax = torch.clamp_min(torch.where(swconfl, tcpa, zero).amax(0), 0.0)
    sdve = colsum(dve_p, mvpmask)
    sdvn = colsum(dvn_p, mvpmask)
    sdvv = colsum(dvv_p, mvpmask)
    tsolv = torch.where(mvpmask, tsolv_p,
                        torch.full_like(tsolv_p, _BIG)).amin(0)
    ncnt = swconfl.sum(0).to(dist.dtype)
    lcnt = swlos.sum(0).to(dist.dtype)

    # Resume-nav keep predicate on every visited pair: flat-earth
    # displacement from the per-aircraft trig, cos(0.5*(lat_o+lat_i)) =
    # sqrt((1+cos(lat_o+lat_i))/2).
    cos_sum = o("cl") * i("cl") - o("sl") * i("sl")
    cos_half = torch.sqrt(torch.clamp_min(0.5 + 0.5 * cos_sum, 0.0))
    dist_e = geo.REARTH * geo.radians(i("lon") - o("lon")) * cos_half
    dist_n = geo.REARTH * geo.radians(i("lat") - o("lat"))
    keep_pair = cr_mvp.resume_keep_core(
        dist_e, dist_n, vrel_e, vrel_n, o("trk"), i("trk"), pairmask,
        p.rpz, p.rpz_resume)
    keep = torch.stack([
        ((gid_int[:, None] == pold[k][None, :]) & keep_pair).any(0)
        for k in range(kk)]).to(dist.dtype)

    # Running top-kk of the fresh candidates by entry time; a stable
    # sort over intruders in ascending id breaks ties to the smaller id.
    cand = swconfl & keep_pair
    urg = torch.where(cand, tinconf, torch.full_like(tinconf, _BIG))
    tin_s, order = torch.sort(urg, dim=0, stable=True)
    ctin = tin_s[:kk]
    cidx = torch.where(ctin < _BIG, gid_int[order[:kk]].to(torch.int32),
                       torch.full_like(order[:kk], _BIG_I, dtype=torch.int32))
    merged, active = merge_partners_block(pold, keep, ctin, cidx)
    return (inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt,
            ctin, cidx, keep, merged, active)


def merge_partners_block(pold, keep, ctin, cidx):
    """Partner merge for one ownship block (``_merge_partners_block``):
    fresh candidates first in urgency order, then the old partners whose
    keep bit survived, in slot order, duplicates of fresh ones dropped.
    All operands [kk, B]; returns (merged [kk, B] int32, active [B])."""
    kk = pold.shape[0]
    new_ids = torch.where(ctin < _BIG, cidx, torch.full_like(cidx, -1))
    old_ids = torch.where(keep > 0.5, pold, torch.full_like(pold, -1))
    dup = ((old_ids[:, None, :] == new_ids[None, :, :])
           & (new_ids[None, :, :] >= 0)).any(1)
    old_ids = torch.where(dup, torch.full_like(old_ids, -1), old_ids)
    cat = torch.cat([new_ids, old_ids]).to(torch.int32)       # [2kk, B]
    rio = torch.arange(2 * kk, device=cat.device)[:, None].expand_as(cat)
    key = torch.where(cat >= 0, rio, torch.full_like(rio, _BIG_I))
    key_s, order = torch.sort(key, dim=0, stable=True)
    merged = torch.gather(cat, 0, order[:kk])
    merged = torch.where(key_s[:kk] < _BIG_I, merged,
                         torch.full_like(merged, -1))
    active = (merged >= 0).any(0).to(ctin.dtype)
    return merged, active


def rows_plain(packed, pold, tiles_of_row, p: TileParams):
    """Run ``row_block_plain`` for every row block.  ``tiles_of_row(i)``
    gives row i's visited intruder blocks in visiting order.  Returns the
    13 outputs in the kernel's layout ([nb, 1|kk, B])."""
    nb, _, B = packed.shape
    dev = packed.device
    lane = torch.arange(B, device=dev, dtype=torch.int64)
    rows = []
    for i in range(nb):
        tiles = torch.as_tensor(tiles_of_row(i), dtype=torch.int64,
                                device=dev)
        intr = packed[tiles].permute(1, 0, 2).reshape(_NF, -1)
        gid_int = (tiles[:, None] * B + lane[None, :]).reshape(-1)
        rows.append(row_block_plain(packed[i], intr, i * B + lane,
                                    gid_int, pold[i], p))
    outs = [torch.stack(parts) for parts in zip(*rows)]
    for j in (0, 1, 2, 3, 4, 5, 6, 7, 12):
        outs[j] = outs[j][:, None, :]
    return outs


def full_grid_resume_plain(packed, reach, pold, p: TileParams):
    """Plain PyTorch version of the ``_kernel_resume`` pass: every row
    block i against every intruder block j with ``reach[i, j]``, in
    ascending j.  ``packed`` [nb, _NF, B] f32, ``reach`` [nb, nb] bool,
    ``pold`` [nb, kk, B] int32.  Returns the 13 outputs."""
    reach_h = reach.cpu().numpy()
    return rows_plain(packed, pold,
                      lambda i: np.flatnonzero(reach_h[i]), p)


def compare_outputs(name, got, want):
    """Hold a kernel's 13 outputs against its plain version's: flags,
    counts, keep bits and the candidate and merged partner sets exactly,
    the float reductions within rtol 1e-4 / atol 5e-3 (f32 summation
    order differs: the kernel sums per thread in tile order, the plain
    version with ``torch.sum``).  Raises ``AssertionError`` naming
    ``name`` on a mismatch; returns the largest absolute difference of
    the float outputs."""
    g = [t.detach().cpu() for t in got]
    w = [t.detach().cpu() for t in want]
    for j, what in ((0, "inconf"), (6, "ncnt"), (7, "lcnt"), (10, "keep"),
                    (12, "active")):
        if not torch.equal(g[j], w[j]):
            raise AssertionError(f"{name}: {what} differs")
    err = 0.0
    for j, what in ((1, "tcpamax"), (2, "sdve"), (3, "sdvn"), (4, "sdvv"),
                    (5, "tsolv"), (8, "ctin")):
        torch.testing.assert_close(g[j], w[j], rtol=1e-4, atol=5e-3,
                                   msg=lambda m: f"{name}: {what}: {m}")
        err = max(err, float((g[j].double() - w[j].double()).abs().max()))

    def sets(ids, valid):
        ids = torch.where(valid, ids, torch.full_like(ids, -1))
        ids = ids.transpose(1, 2).reshape(-1, ids.shape[1]).numpy()
        return [frozenset(r[r >= 0].tolist()) for r in ids]
    if sets(g[9], g[8] < _BIG) != sets(w[9], w[8] < _BIG):
        raise AssertionError(f"{name}: candidate sets differ")
    if sets(g[11], g[11] >= 0) != sets(w[11], w[11] >= 0):
        raise AssertionError(f"{name}: merged partner sets differ")
    return err


def alloc_outputs(nb, kk, B, device):
    """Output tensors of one kernel launch: the 8 accumulators share one
    [8, nb, 1, B] buffer, then ctin, cidx, keep, merged, active."""
    f32 = dict(dtype=torch.float32, device=device)
    acc = torch.empty((8, nb, 1, B), **f32)
    return (acc, torch.empty((nb, kk, B), **f32),
            torch.empty((nb, kk, B), dtype=torch.int32, device=device),
            torch.empty((nb, kk, B), **f32),
            torch.empty((nb, kk, B), dtype=torch.int32, device=device),
            torch.empty((nb, 1, B), **f32))


def check_common(packed, pold):
    """Validate the slab and partner-table operands of a kernel launch."""
    from . import _cuda
    nb, nf, B = packed.shape
    if nf != _NF or not 0 < B <= 256:
        raise ValueError(f"packed must be [nb, {_NF}, B<=256], "
                         f"got {tuple(packed.shape)}")
    if pold.shape[1] != KK:
        raise ValueError(f"the CUDA tile kernels take K = {KK} partners")
    _cuda.require(packed, torch.float32, (nb, _NF, B), "packed")
    _cuda.require(pold, torch.int32, (nb, KK, B), "pold")
    return nb, B


def full_grid_resume(packed, reach, pold, p: TileParams):
    """The overflow-row fallback pass: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (see ``full_grid_resume_plain``)."""
    if not packed.is_cuda:
        return full_grid_resume_plain(packed, reach, pold, p)
    from . import _cuda
    nb, B = check_common(packed, pold)
    reach_u8 = reach.to(torch.uint8).contiguous()
    _cuda.require(reach_u8, torch.uint8, (nb, nb), "reach")
    acc, ctin, cidx, keep, merged, active = alloc_outputs(nb, KK, B,
                                                          packed.device)
    lib = _cuda.load("cd_tiles.cu")
    rc = lib.cd_full_grid_resume(
        packed.data_ptr(), nb, B, reach_u8.data_ptr(), pold.data_ptr(),
        p.rpz, p.rpz * p.rpz, p.hpz, p.tlookahead, p.rpz_m, p.hpz_m,
        p.tlook_m, p.rpz_resume, acc.data_ptr(), ctin.data_ptr(),
        cidx.data_ptr(), keep.data_ptr(), merged.data_ptr(),
        active.data_ptr(), _cuda.stream_ptr(packed.device))
    _cuda.check(rc, "cd_full_grid_resume")
    LAUNCHES["cd_full_grid_resume"] += 1
    return list(acc.unbind(0)) + [ctin, cidx, keep, merged, active]
