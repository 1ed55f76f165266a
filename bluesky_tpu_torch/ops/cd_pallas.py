"""Fused blockwise CD&R: the ``pallas`` backend and its tile kernels.

Port of ``bluesky_tpu/ops/cd_pallas.py``: the packed slab layout
(``_FIELDS``), the per-pair tile body with and without the resume keep
predicate (``row_block_plain``), the partner merge
(``merge_partners_block``), the candidate tables (``build_candidates``)
and ``detect_resolve_pallas``, the CD&R of ``SimConfig(cd_backend=
"pallas")``: Morton-sorted slots, the exact block reachability, and the
reach-masked full grid or, with ``cand_cap > 0``, the candidate-list
scheduler with the full grid covering its overflow rows.

Three TPU kernels become the split walker of ``csrc/cd_tiles.cu`` (one
thread per ownship): each row block's tiles are cut into balanced work
items (``work_items``), one CTA per item, and the items' partials are
folded by the row merge ``cd_merge_items`` (``merge_items_plain``).  Each
wrapper stands beside a plain PyTorch version of the same function:

* ``_kernel`` -> ``cd_full_grid`` over the reachable blocks
  (``full_grid`` / ``full_grid_plain``);
* ``_kernel_cand`` -> ``cd_cand_items`` over the sub-chunks of each
  row's candidate table (``cand_tiles`` / ``cand_tiles_plain``);
* ``_kernel_resume`` -> ``cd_sched_tiles`` over the reachable blocks of
  the overflow rows (``full_grid_resume`` / ``full_grid_resume_plain``),
  the sparse scheduler's overflow fallback.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors.

The walker's mesh forms (ROADMAP B3, ``MeshForm``) serve the shard modes
of ``cd_sched.detect_resolve_sched`` and the replicate row split of
``detect_resolve_pallas``: a row subset of the grid (own-row slabs, local
row i global row ``row0 + i * rstride``; ``interleave_rows``), a halo
window of the columns (local block j global block ``col0 + j``) or a
present set with a global block table (``gid``).  Slabs are read at
their local indices; pair exclusion, partner ids and the old-partner
test use the global ones.

The tile body has three resolver forms (``reso``, a compile-time
parameter of the walker): ``"mvp"`` the MVP pair sums, ``"eby"`` the
Eby pair sums (``cr_eby.pair_contrib``) on the TAS velocities of the
``tr`` slab row, ``"swarm"`` the MVP sums plus seven neighbour sums
(``cr_swarm.pair_weight``, the CAS in the ``tr`` row) appended to the
outputs.  The CUDA kernels and the plain versions take any partner width
K >= 1: ``KK`` = 8, the default of every path, is compiled as a constant,
K up to ``KWORD`` = 32 takes the run-time form, and a wider K the wide
form (the top-K lists in device memory, ``KW`` keep words an ownship).
The only limit is memory, which ``check_common`` and ``walk_items``
check in bytes.

The plain versions and the kernels visit a row's intruders in ascending
slot id (tiles in ascending block order; candidate ids ascend within a
row) and break top-K ties towards the smaller intruder id, which is
exactly the Pallas extraction order (smallest ``tinconf`` first, ties to
the smaller id, earlier tiles win across tiles).  Masked pairs
(inactive, self) are left out instead of being pushed out of range with
``_BIG``.
"""
import contextlib
from typing import NamedTuple

import numpy as np
import torch

from . import cd_tiled, cr_eby, cr_mvp, cr_swarm, geo
from ..parallel.dist import allgather_shards, process_index, spans_ranks
from .cd_tiled import (RowConflictData, TRIG_FIELDS, block_reachability,
                       precompute_trig, tile_geometry)

# Packed slab rows of the [nb, 16, block] arrays.  The "tr" row is
# overloaded per resolver (tas/gs ratio for Eby, cas for Swarm); MVP
# never reads it and the contract keeps it at 16 rows.
_FIELDS = TRIG_FIELDS + ("u", "v", "alt", "vs", "gse", "gsn", "trk",
                         "tr", "active", "noreso")
_NF = len(_FIELDS)
_IDX = {k: i for i, k in enumerate(_FIELDS)}
_BIG = 1e9
_BIG_I = 2 ** 30
#: Candidate sub-block width: candidate ids come in runs of this many
#: consecutive slots, one warp's contiguous load in ``cd_cand_items``.
CAND_SUB = 32
#: The default partner-table width K (columns of ``partners_s``), the
#: kernels' constant form.
KK = 8
#: The widest K whose keep bits are one 32-bit word an ownship: the
#: kernels' narrow forms; a wider K takes the wide form.
KWORD = 32
#: Shared memory a CTA may hold on the card (H100: 227 KB).
MAX_CTA_SHARED = 232_448
#: Static shared memory of a walker CTA: the [16, 256] f32 slab, and the
#: staged ids of the candidate pass (one int otherwise).
_STATIC_SMEM = _NF * 256 * 4
#: Work items a row block's tiles are cut into at most (``work_items``):
#: ``full_grid`` and ``cd_sched.sched_tiles``, ``full_grid_resume`` and
#: ``cand_tiles``.  Each is the smallest of 4, 8 and 16 within one call's
#: spread of the best in ``scripts/torch_kernels_ab.py`` (``PERF.md`` §6).
ITEMS_PER_ROW = 8
RESUME_ITEMS_PER_ROW = 16
CAND_ITEMS_PER_ROW = 16

#: Identity elements of the 10 accumulator outputs, in output order:
#: inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt, ctin, cidx.
_ACC_NEUTRAL = (0.0, 0.0, 0.0, 0.0, 0.0, _BIG, 0.0, 0.0, _BIG, _BIG_I)

#: The resolver forms of the tile body, by their code in ``cd_tiles.cu``.
RESO_CODE = {"mvp": 0, "eby": 1, "swarm": 2}
#: Swarm neighbour sums appended to the outputs of the swarm form, in
#: ``cr_swarm.resolve_from_sums`` order: w, w*cas, w*vs, w*dtrk, w*dx,
#: w*dy, w*alt.
N_SWARM = 7
SWARM_SUMS = ("sw_w", "sw_cas", "sw_vs", "sw_dtrk", "sw_dx", "sw_dy",
              "sw_alt")


#: The mesh forms of the walker, by ``MeshForm.kind``.
MESH_KINDS = ("rows", "col0", "gid")


def launch_key(name, reso, kind=None):
    """The ``LAUNCHES`` key of kernel ``name`` in resolver form ``reso``
    (the MVP form keeps the plain name), and in mesh form ``kind``
    (``MESH_KINDS``) after a slash."""
    key = name if reso == "mvp" else f"{name}_{reso}"
    return key if kind is None else f"{key}/{kind}"


#: Launches of each CUDA kernel of this module in each resolver form and
#: mesh form since the last reset (plain versions and CPU calls do not
#: count).
LAUNCHES = {launch_key(k, r, m): 0
            for k, kinds in (("cd_full_grid_resume", (None, "rows", "col0")),
                             ("cd_full_grid", (None, "rows", "col0")),
                             ("cd_cand_tiles", (None,)))
            for r in RESO_CODE for m in kinds}


class MeshForm(NamedTuple):
    """The mesh form of a walk (``cd_tiles.cu`` struct Mesh): the ownship
    rows are the row blocks of ``own`` [nbr, _NF, B], local row i being
    global row ``row0 + i * rstride``; the tiles index the column slabs,
    local block j being global block ``gid[j]`` ([ncols] int32 on the
    slabs' device) or, without a table, ``col0 + j``.  Slot ids are
    global: ``block * B + lane``."""
    own: torch.Tensor
    row0: int = 0
    rstride: int = 1
    col0: int = 0
    gid: torch.Tensor = None

    @property
    def kind(self):
        """``"gid"`` with a table, ``"rows"`` for a strided row subset
        (the replicate split), else ``"col0"`` (a halo window)."""
        if self.gid is not None:
            return "gid"
        return "rows" if self.rstride > 1 else "col0"

    def col_blocks(self, ncols):
        """[ncols] int64: the global block of each column slab (CPU)."""
        if self.gid is not None:
            return self.gid.cpu().long()
        return torch.arange(ncols) + int(self.col0)


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


def tile_params(rpz, hpz, tlookahead, mvpcfg, resume_rpz_m=0.0) -> TileParams:
    """``resume_rpz_m`` is read by the resume kernels only."""
    return TileParams(float(rpz), float(hpz), float(tlookahead),
                      float(mvpcfg.rpz_m), float(mvpcfg.hpz_m),
                      float(mvpcfg.tlookahead), float(resume_rpz_m))


def kernel_floats(p: TileParams):
    """The 10 floating-point arguments every walker entry point of
    ``cd_tiles.cu`` takes: 8 floats, then (doubles) the scale ``1/rpz_m``
    of ``cr_eby.pair_contrib`` and 10 m in that scale, as the plain
    version computes them."""
    s = 1.0 / p.rpz_m
    return (p.rpz, p.rpz * p.rpz, p.hpz, p.tlookahead, p.rpz_m, p.hpz_m,
            p.tlook_m, p.rpz_resume, s, 10.0 * s)


def _rdiv(c, t):
    """``c / t`` as one correctly rounded division (a Python scalar
    divided by a tensor would otherwise become reciprocal-then-multiply,
    two roundings), as the kernel and the JAX reference compute it."""
    return torch.div(torch.full((), c, dtype=t.dtype, device=t.device), t)


def conflict_terms(own, intr, gid_own, gid_int, p: TileParams):
    """The conflict geometry of the tile body (``row_block_plain``) for
    every pair of the ownships ``own`` [_NF, B] and the intruders
    ``intr`` [_NF, M] (slot ids ``gid_own`` [B], ``gid_int`` [M]), in
    the slabs' dtype: a dict of [M, B] tensors, among them the
    compared quantities ``dcpa2`` (against ``rpz**2``), ``tinconf``,
    ``toutconf`` (against each other, 0 and the lookahead), ``dist`` and
    ``dalt``, the terms of the window (``tcpa``, ``rvrel``, the vertical
    crossing times ``tcrosshi``/``tcrosslo``), and the flags
    ``pairmask``, ``swconfl`` and ``swlos``."""
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
    return dict(pairmask=pairmask, dist=dist, sinq=sinq, cosq=cosq, dx=dx,
                dy=dy, rvrel=rvrel, tcpa=tcpa, dcpa2=dcpa2,
                tcrosshi=tcrosshi, tcrosslo=tcrosslo, tinconf=tinconf,
                toutconf=toutconf, dalt=dalt, vrel_v=vrel_v, swhor=swhor,
                swconfl=swconfl, swlos=swlos)


def row_block_plain(own, intr, gid_own, gid_int, pold, p: TileParams,
                    reso="mvp", kk=KK):
    """One ownship row block against its visited intruders.

    ``own`` [_NF, B] ownship slab; ``intr`` [_NF, M] the visited
    intruders in visiting order with their slot ids ``gid_int`` [M];
    ``gid_own`` [B]; ``pold`` [kk, B] the old partner table (sorted-space
    ids, -1 empty) or None.  With ``pold`` this is the resume body
    (``_kernel_resume``: keep predicate, fresh candidates filtered by it,
    partner merge) and returns 13 per-row outputs: eight [B]
    accumulators, ctin/cidx/keep/merged [kk, B] and active [B].  Without
    it this is the ``_kernel`` body (every conflict pair a candidate) and
    returns the first 10; ``kk`` is then the top-K width.  ``reso``
    picks the resolver form; ``"swarm"`` appends the ``N_SWARM``
    neighbour sums [B]."""
    kk = kk if pold is None else pold.shape[0]
    if intr.shape[1] < kk:
        # pad with inactive intruders so every reduction and the top-kk
        # have at least kk rows to work on
        pad = kk - intr.shape[1]
        intr = torch.cat([intr, intr.new_zeros((_NF, pad))], 1)
        gid_int = torch.cat([gid_int, gid_int.new_full((pad,), _BIG_I)])
    o = lambda k: own[_IDX[k]][None, :]                  # [1, B]
    i = lambda k: intr[_IDX[k]][:, None]                 # [M, 1]
    c = conflict_terms(own, intr, gid_own, gid_int, p)
    (pairmask, dist, sinq, cosq, dx, dy, tcpa, tinconf, dalt, vrel_v,
     swconfl, swlos) = (c[k] for k in (
         "pairmask", "dist", "sinq", "cosq", "dx", "dy", "tcpa", "tinconf",
         "dalt", "vrel_v", "swconfl", "swlos"))
    vrel_e = i("gse") - o("gse")
    vrel_n = i("gsn") - o("gsn")

    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    if reso == "eby":
        # TAS velocities from the tas/gs ratio of the tr row; no noreso
        # mask, tsolv left at _BIG
        dve_p, dvn_p, dvv_p = cr_eby.pair_contrib(
            dx, dy, dalt, i("tr") * i("u") - o("tr") * o("u"),
            i("tr") * i("v") - o("tr") * o("v"), vrel_v, p.rpz_m)
        tsolv_p = torch.full_like(dve_p, _BIG)
        mvpmask = swconfl
    else:
        mvp = cr_mvp.MVPConfig(rpz_m=p.rpz_m, hpz_m=p.hpz_m,
                               tlookahead=p.tlook_m)
        dve_p, dvn_p, dvv_p, tsolv_p = cr_mvp.pair_contrib_trig(
            sinq, cosq, dist, tcpa, tinconf, dalt, vrel_e, vrel_n, vrel_v,
            mvp)
        mvpmask = swconfl & ~(i("noreso") > 0.5)

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

    cand = swconfl
    if pold is not None:
        # Resume-nav keep predicate on every visited pair: flat-earth
        # displacement from the per-aircraft trig, cos(0.5*(lat_o+lat_i))
        # = sqrt((1+cos(lat_o+lat_i))/2).
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
        cand = swconfl & keep_pair

    # Running top-kk of the fresh candidates by entry time; a stable
    # sort over intruders in visiting order breaks ties to the earlier.
    urg = torch.where(cand, tinconf, torch.full_like(tinconf, _BIG))
    tin_s, order = torch.sort(urg, dim=0, stable=True)
    ctin = tin_s[:kk]
    cidx = torch.where(ctin < _BIG, gid_int[order[:kk]].to(torch.int32),
                       torch.full_like(order[:kk], _BIG_I, dtype=torch.int32))
    outs = (inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt, ctin, cidx)
    if pold is not None:
        outs += (keep,) + merge_partners_block(pold, keep, ctin, cidx)
    if reso == "swarm":
        # every visited pair, not only the conflict pairs; the tr row
        # holds the CAS
        dtrk = cr_swarm.wrap_track(i("trk") - o("trk"))
        w = cr_swarm.pair_weight(dx, dy, dalt, dtrk, pairmask)
        outs += (w.to(dist.dtype).sum(0),) + tuple(
            colsum(t.expand_as(dx), w)
            for t in (i("tr"), i("vs"), dtrk, dx, dy, i("alt")))
    return outs


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


def block_ids(tiles, B):
    """Slot ids of the intruder blocks ``tiles`` (ascending lanes)."""
    tiles = torch.as_tensor(np.asarray(tiles, np.int64))
    return (tiles[:, None] * B + torch.arange(B)[None, :]).reshape(-1)


def rows_plain(packed, pold, ids_of_row, p: TileParams, reso="mvp", kk=KK,
               mesh: MeshForm = None, rows=None):
    """Run ``row_block_plain`` for every row block, or for the row blocks
    ``rows`` (a sequence of row ids; the outputs then hold those rows, in
    that order: a sampled hold of a large grid).  ``ids_of_row(i)``
    gives row i's intruder slot ids in visiting order; id ``nb * B`` is
    the all-inactive sentinel column.  Returns the 13 outputs (10 when
    ``pold`` is None; the swarm form adds ``N_SWARM``) in the kernel's
    layout ([nb, 1|kk, B]).  A row without intruders gives the identity
    elements whatever its own slab and old partners (every pair is
    masked), so the first such row's outputs serve the others.  With
    ``mesh`` the rows are those of ``mesh.own`` and ``ids_of_row`` gives
    local slot ids of the column slabs ``packed``, lifted to global ids
    by the mesh form's maps."""
    nc, _, B = packed.shape
    own = packed if mesh is None else mesh.own
    nb = own.shape[0]
    dev = packed.device
    lane = torch.arange(B, device=dev, dtype=torch.int64)
    allf = torch.cat([packed.transpose(0, 1).reshape(_NF, nc * B),
                      packed.new_zeros((_NF, 1))], 1)
    lift = lambda ids: ids
    row_gid = lambda i: i * B + lane
    if mesh is not None:
        gblk = mesh.col_blocks(nc).to(dev)

        def lift(ids):
            blk = ids // B
            g = gblk[torch.clamp(blk, max=nc - 1)] * B + ids % B
            return torch.where(blk < nc, g, ids)

        row_gid = lambda i: (mesh.row0 + i * mesh.rstride) * B + lane
    outs, empty = [], None
    for i in range(nb) if rows is None else (int(r) for r in rows):
        ids = torch.as_tensor(ids_of_row(i), device=dev).long()
        if ids.numel() == 0 and empty is not None:
            outs.append(empty)
            continue
        outs.append(row_block_plain(own[i], allf[:, ids], row_gid(i),
                                    lift(ids),
                                    None if pold is None else pold[i],
                                    p, reso, kk))
        if ids.numel() == 0:
            empty = outs[-1]
    outs = [torch.stack(parts) for parts in zip(*outs)]
    nfix = 10 if pold is None else 13
    for j in list(range(8)) + ([12] if pold is not None else []) \
            + list(range(nfix, len(outs))):
        outs[j] = outs[j][:, None, :]
    return outs


def world_base(rows, nbw, device=None):
    """[rows] int64 first block of each row's world: row i of a stack of
    worlds of ``nbw`` row blocks each belongs to world ``i // nbw``."""
    return torch.arange(rows, device=device) // nbw * nbw


def _reach_rows(reach, B, worlds=True):
    """Row i's intruder slot ids: the blocks j with ``reach[i, j]``, in
    row i's world (``reach`` [W * nbw, nbw] for a stack of worlds; with
    ``worlds`` False the columns are the same for every row, the local
    column blocks of a mesh form)."""
    reach_h = reach.cpu().numpy()
    nbw = reach_h.shape[1]
    base = (lambda i: i // nbw * nbw) if worlds else (lambda i: 0)
    return lambda i: block_ids(np.flatnonzero(reach_h[i]) + base(i), B)


def interleave_rows(nb, ndev):
    """The replicate row split (JAX ``interleave_rows``): shard d owns
    global row blocks d, d + D, 2D + d, ...  Returns ``(rows_l, nbrp,
    rperm, rinv)``: row blocks per shard, the padded row count, the
    permutation placing global row j * D + d at index d * rows_l + j,
    and its inverse (numpy int64 arrays)."""
    nbrp = -(-nb // ndev) * ndev
    rows_l = nbrp // ndev
    rperm = np.arange(nbrp).reshape(rows_l, ndev).T.reshape(-1)
    return rows_l, nbrp, rperm, np.argsort(rperm)


def full_grid_resume_plain(packed, reach, pold, p: TileParams, reso="mvp",
                           mesh: MeshForm = None, rows=None):
    """Plain PyTorch version of the ``_kernel_resume`` pass: every row
    block i against every intruder block j with ``reach[i, j]``, in
    ascending j.  ``packed`` [nb, _NF, B] f32, ``reach`` [nb, nb] bool,
    ``pold`` [nb, kk, B] int32.  Returns the 13 outputs (20 for the
    swarm form).  A stack of W worlds of nbw row blocks each passes
    ``packed`` [W * nbw, _NF, B] and ``reach`` [W * nbw, nbw] (each row's
    reach in its own world); slot ids and ``pold`` are then global, world
    w's slot s being ``w * nbw * B + s``.  With ``mesh`` (``MeshForm``)
    the rows are ``mesh.own``'s and ``reach`` [nbr, ncols] indexes the
    column slabs ``packed``; ``pold`` holds global ids.  ``rows`` as in
    ``rows_plain``."""
    return rows_plain(packed, pold, _reach_rows(reach, packed.shape[2],
                                                mesh is None), p, reso,
                      mesh=mesh, rows=rows)


def full_grid_plain(packed, reach, p: TileParams, reso="mvp", kk=KK,
                    mesh: MeshForm = None, rows=None):
    """Plain PyTorch version of the ``_kernel`` pass: the reach-masked
    full grid without a partner table, top-``kk`` candidates.  Returns
    the 10 outputs (17 for the swarm form).  ``mesh`` and ``rows`` as in
    ``full_grid_resume_plain``."""
    return rows_plain(packed, None, _reach_rows(reach, packed.shape[2],
                                                mesh is None), p, reso, kk,
                      mesh=mesh, rows=rows)


def cand_tiles_plain(packed, cand, p: TileParams, reso="mvp", kk=KK,
                     rows=None):
    """Plain PyTorch version of the ``_kernel_cand`` pass: row block i
    against the aircraft of its candidate table ``cand[i]`` ([nb, c_cap]
    int32 slot ids, ascending, sentinel ``nb * B`` inactive).  Returns
    the 10 outputs; no swarm form (Swarm with candidates raises).
    ``rows`` as in ``rows_plain``."""
    return rows_plain(packed, None, lambda i: cand[i], p, reso, kk,
                      rows=rows)


def compare_outputs(name, got, want):
    """Hold a kernel's outputs (13 for the resume kernels, 10 for the
    others, each with the ``N_SWARM`` swarm sums after them in the swarm
    form) against its plain version's: flags, counts, keep bits and the
    candidate and merged partner sets exactly, the float reductions and
    the swarm sums within rtol 1e-4 / atol 5e-3 (f32 summation order
    differs: the kernel sums per thread in tile order, the plain version
    with ``torch.sum``).  Raises ``AssertionError`` naming ``name`` on a
    mismatch; returns the largest absolute difference of the float
    outputs."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, want {len(want)}")
    nfix = len(got) - N_SWARM if len(got) in (10 + N_SWARM, 13 + N_SWARM) \
        else len(got)
    g = [t.detach().cpu() for t in got]
    w = [t.detach().cpu() for t in want]
    for j, what in ((0, "inconf"), (6, "ncnt"), (7, "lcnt"), (10, "keep"),
                    (12, "active")):
        if j < nfix and not torch.equal(g[j], w[j]):
            raise AssertionError(f"{name}: {what} differs")
    err = 0.0
    for j, what in ((1, "tcpamax"), (2, "sdve"), (3, "sdvn"), (4, "sdvv"),
                    (5, "tsolv"), (8, "ctin"),
                    *zip(range(nfix, len(g)), SWARM_SUMS)):
        torch.testing.assert_close(g[j], w[j], rtol=1e-4, atol=5e-3,
                                   msg=lambda m: f"{name}: {what}: {m}")
        err = max(err, float((g[j].double() - w[j].double()).abs().max()))

    def sets(ids, valid):
        """Each ownship's ids, sorted: equal rows are equal sets (a row
        holds no id twice)."""
        ids = torch.where(valid, ids, torch.full_like(ids, -1))
        return torch.sort(ids, dim=1).values
    if not torch.equal(sets(g[9], g[8] < _BIG), sets(w[9], w[8] < _BIG)):
        raise AssertionError(f"{name}: candidate sets differ")
    if nfix > 11 and not torch.equal(sets(g[11], g[11] >= 0),
                                     sets(w[11], w[11] >= 0)):
        raise AssertionError(f"{name}: merged partner sets differ")
    return err


def compare_rows(name, got, want):
    """Hold two ``RowConflictData`` against each other: inconf, nconf,
    nlos and the top-K ids exactly, the float reductions within rtol
    1e-4 / atol 5e-3.  Raises ``AssertionError`` naming ``name``."""
    for k in ("inconf", "nconf", "nlos", "topk_idx"):
        if not torch.equal(getattr(got, k).cpu(), getattr(want, k).cpu()):
            raise AssertionError(f"{name}: {k} differs")
    for k in ("tcpamax", "sum_dve", "sum_dvn", "sum_dvv", "tsolv",
              "topk_tin"):
        torch.testing.assert_close(getattr(got, k).cpu(),
                                   getattr(want, k).cpu(), rtol=1e-4,
                                   atol=5e-3,
                                   msg=lambda m: f"{name}: {k}: {m}")


def alloc_outputs(nb, kk, B, device, resume=True, nacc=8):
    """Output tensors of one kernel launch: the ``nacc`` accumulators (8,
    15 in the swarm form) share one [nacc, nb, 1, B] buffer, then ctin,
    cidx and, for the resume kernels, keep, merged, active."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    outs = (torch.empty((nacc, nb, 1, B), **f32),
            torch.empty((nb, kk, B), **f32), torch.empty((nb, kk, B), **i32))
    if resume:
        outs += (torch.empty((nb, kk, B), **f32),
                 torch.empty((nb, kk, B), **i32),
                 torch.empty((nb, 1, B), **f32))
    return outs


def keep_words(kk):
    """32-bit keep words an ownship holds at partner width ``kk``."""
    return -(-kk // KWORD)


def cta_shared_bytes(kk, B, reso="mvp", ids=False):
    """Shared memory of one walker CTA at partner width ``kk`` and block
    ``B``: the staged slab (and ids), ``Side`` of ``cd_tiles.cu`` and the
    Swarm sums.  ``Side`` holds, up to K = ``KWORD``, the top-K times and
    ids and the old partners, [kk] each, then the keep bits, gse, gsn and
    trk: 3 kk + 4 words a thread, in rows of stride 256 in the constant
    K = ``KK`` form, B otherwise; in the wide form only the ``KW`` keep
    words, ``KW`` words of the tile's old-partner mask, two counts and
    gse, gsn, trk: 2 KW + 5 words a thread (the top-K lists live in
    device memory)."""
    words = 2 * keep_words(kk) + 5 if kk > KWORD else 3 * kk + 4
    return (_STATIC_SMEM + (256 if ids else 1) * 4
            + words * (256 if kk == KK else B) * 4
            + (N_SWARM * B * 4 if reso == "swarm" else 0))


def check_common(packed, pold=None, kk=KK, reso="mvp"):
    """Validate the slab and partner-table operands of a kernel launch:
    the partner width K >= 1 with a CTA's shared memory within
    ``MAX_CTA_SHARED`` bytes, and ``reso`` a resolver form."""
    from . import _cuda
    nb, nf, B = packed.shape
    if nf != _NF or not 0 < B <= 256:
        raise ValueError(f"packed must be [nb, {_NF}, B<=256], "
                         f"got {tuple(packed.shape)}")
    if reso not in RESO_CODE:
        raise ValueError(f"unknown resolver form {reso!r}; expected one of "
                         f"{tuple(RESO_CODE)}")
    if pold is not None:
        kk = pold.shape[1]
    if kk < 1:
        raise ValueError(f"the partner width K must be >= 1, not {kk}")
    smem = cta_shared_bytes(kk, B, reso, ids=True)
    if smem > MAX_CTA_SHARED:
        raise ValueError(
            f"K = {kk} partners at B = {B} take {smem} bytes of shared "
            f"memory a CTA, past the {MAX_CTA_SHARED} a CTA may hold")
    _cuda.require(packed, torch.float32, (nb, _NF, B), "packed")
    if pold is not None:
        _cuda.require(pold, torch.int32, (nb, kk, B), "pold")
    return nb, B


class WorkItems(NamedTuple):
    """The work items of a split walker (``cd_full_grid``,
    ``cd_sched_tiles``, ``cd_cand_items``): item k of row block i walks
    ``tiles[i, start[i, k] : start[i, k] + length[i, k]]``."""
    tiles: torch.Tensor    # [nb, W] int32 each row's tiles, ascending, first
    start: torch.Tensor    # [nb, C] int32 an item's first position in them
    length: torch.Tensor   # [nb, C] int32 its tile count (0: empty item)
    order: torch.Tensor    # [nb] int32 rows, longest items first


def compact_rows(cand, valid):
    """Row-wise compaction by a cumsum: the entries of ``cand`` [nb, W]
    where ``valid``, in their order, moved to the front of each row.
    Returns ``(tiles [nb, W] int32, count [nb] int64)``; entries past a
    row's count are 0."""
    nb, w = cand.shape
    pos = torch.where(valid, torch.cumsum(valid, 1) - 1,
                      torch.full((), w, device=cand.device))
    out = torch.zeros((nb, w + 1), dtype=torch.int32, device=cand.device)
    out.scatter_(1, pos, cand.to(torch.int32))   # column w takes the rest
    return out[:, :w].contiguous(), valid.sum(1)


def work_items(tiles, count, per_row=ITEMS_PER_ROW):
    """Cut each row's ``count`` tiles (``compact_rows``) into at most
    ``per_row`` items of ``ceil(count / per_row)`` tiles, in order; the
    rows are ordered by descending item length (the launch order, so the
    longest items do not start last).  Tensor ops only: no host sync."""
    count = count.long()
    dev = count.device
    size = torch.clamp_min((count + per_row - 1) // per_row, 1)
    k = torch.arange(per_row, dtype=torch.int64, device=dev)
    start = k[None, :] * size[:, None]
    length = torch.minimum(torch.clamp_min(count[:, None] - start, 0),
                           size[:, None])
    order = torch.argsort(-(size * (count > 0)), stable=True)
    return WorkItems(tiles=tiles, start=start.to(torch.int32),
                     length=length.to(torch.int32),
                     order=order.to(torch.int32))


def mask_items(mask, per_row, nbw=None):
    """``work_items`` of a row mask: row i's tiles are the columns j with
    ``mask[i, j]`` ([nb, W] bool), ascending.  For a CUDA mask one call of
    ``cd_mask_items`` (a block scan per row, then the launch order)
    builds them: the dozen tensor ops of the plain version,
    ``compact_rows`` + ``work_items``, cost more host time than a pass
    that finds no tile.  Either way nothing waits for the device.

    With ``nbw`` the mask is a stack of worlds of ``nbw`` row blocks
    ([W * nbw, nbw], each row's columns the blocks of its own world): the
    tiles of row i are offset by its world's first block ``world_base``,
    so one walker launch serves the whole stack."""
    nb, w = mask.shape
    worlds = nbw is not None and nbw != nb
    if not mask.is_cuda:
        cols = torch.arange(w, dtype=torch.int32).expand(nb, w)
        if worlds:
            cols = cols + world_base(nb, w).to(torch.int32)[:, None]
        return work_items(*compact_rows(cols, mask), per_row)
    from . import _cuda
    _cuda.require(mask, torch.bool, (nb, w), "mask")
    i32 = dict(dtype=torch.int32, device=mask.device)
    items = WorkItems(tiles=torch.empty((nb, w), **i32),
                      start=torch.empty((nb, per_row), **i32),
                      length=torch.empty((nb, per_row), **i32),
                      order=torch.empty((nb,), **i32))
    rc = _cuda.load("cd_tiles.cu").cd_mask_items(
        mask.data_ptr(), nb, w, per_row, *(t.data_ptr() for t in items),
        _cuda.stream_ptr(mask.device))
    _cuda.check(rc, "cd_mask_items")
    if worlds:
        items.tiles.add_(world_base(nb, w, mask.device)
                         .to(torch.int32)[:, None])
    return items


def reach_items(reach, per_row=ITEMS_PER_ROW, worlds=True):
    """``work_items`` of the reach-masked full grid: row i's tiles are the
    blocks j with ``reach[i, j]``, ascending, in row i's world for a
    stack of worlds (``reach`` [W * nbw, nbw]); with ``worlds`` False
    the columns of every row are the same slabs (a mesh form's local
    column blocks)."""
    return mask_items(reach, per_row, nbw=reach.shape[1] if worlds else None)


def cand_items(cand, B, per_row=CAND_ITEMS_PER_ROW):
    """``work_items`` of the candidate pass: row i's tiles are the
    sub-chunks of B entries of its candidate table ``cand[i]`` that hold
    an id: ``build_candidates`` gives ascending ids, then the sentinel
    ``nb * B``, so these are the first ``ceil(count_i / B)``, none on an
    overflow row."""
    return mask_items(cand[:, ::B] < cand.shape[0] * B, per_row)


def merge_items_plain(parts, B, pold=None, reso="mvp", kk=KK):
    """Plain PyTorch version of ``cd_merge_items`` for one row block: the
    outputs of ``row_block_plain`` on each of the row's non-empty work
    items, in ascending item order, folded into the row's outputs.  Sums
    and counts add in item order, tcpamax takes the max, tsolv the min,
    inconf and (with ``pold``) the keep bits or; the top-kk lists merge by
    (tin, id), the order of the kernel's insert over ascending ids.  With
    ``pold`` [kk, B] the partner merge follows and the 13 outputs are
    returned, else the 10; the swarm form adds its sums in item order."""
    if pold is not None:
        kk = pold.shape[0]
    nfix = 10 if pold is None else 13
    if not parts:       # a row without tiles: the identity elements
        dev = "cpu" if pold is None else pold.device
        ident = [torch.full((B,) if j < 8 else (kk, B), v, device=dev,
                            dtype=torch.int32 if j == 9 else torch.float32)
                 for j, v in enumerate(_ACC_NEUTRAL)]
        if pold is not None:        # keep bits; merged and active unread
            ident += [torch.zeros((kk, B), device=dev)] * 3
        parts = [ident + [torch.zeros(B, device=dev)] * N_SWARM]
    cols = list(zip(*parts))
    add = lambda j: sum(cols[j], torch.zeros_like(cols[j][0]))
    sdve, sdvn, sdvv, ncnt, lcnt = (add(j) for j in (2, 3, 4, 6, 7))
    inconf = torch.stack(cols[0]).amax(0)
    tcpamax = torch.stack(cols[1]).amax(0)
    tsolv = torch.stack(cols[5]).amin(0)
    tin, ids = torch.cat(cols[8]), torch.cat(cols[9])        # [items*kk, B]
    by_id = torch.sort(ids, dim=0, stable=True).indices
    by_tin = torch.sort(torch.gather(tin, 0, by_id), dim=0,
                        stable=True).indices
    first = torch.gather(by_id, 0, by_tin)[:kk]
    ctin, cidx = torch.gather(tin, 0, first), torch.gather(ids, 0, first)
    outs = (inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt, ctin, cidx)
    if pold is not None:
        keep = torch.stack(cols[10]).amax(0)
        outs += (keep,) + merge_partners_block(pold, keep, ctin, cidx)
    if reso == "swarm":
        outs += tuple(add(j) for j in range(nfix, nfix + N_SWARM))
    return outs


def alloc_or_raise(what, nbytes, make):
    """``make()``, the allocation of a launch's buffers, which take
    ``nbytes`` bytes; where the device has no room for them a
    ``ValueError`` naming the bytes.  Nothing is asked of the device
    beforehand: a ``torch.cuda.mem_get_info`` a launch costs about a
    millisecond on the card (PERF.md §6)."""
    try:
        return make()
    except torch.cuda.OutOfMemoryError as e:
        raise ValueError(f"{what} take {nbytes} bytes, more than the "
                         f"device has free") from e


def walk_items(packed, items, p: TileParams, pold=None, cand=None,
               reso="mvp", kk=KK, mesh: MeshForm = None):
    """Launch a split walker on ``items``: ``cd_sched_tiles`` with the
    partner table ``pold`` (its width is K), ``cd_cand_items`` with the
    candidate table ``cand`` (the tiles are its sub-chunks),
    ``cd_full_grid`` with neither (also the no-resume segment pass of
    ``cd_sched.sched_tiles``), in resolver form ``reso`` with top-K
    lists ``kk`` wide, and in the mesh form ``mesh`` (not the candidate
    pass: the rows are then ``mesh.own``'s, the tiles local blocks of
    ``packed``).  Returns the items' partials ``(acc [8|15, G, B],
    ct [K, G, B], ci, keep [G, KW, B] or None)``, G = nb * C, KW =
    ``keep_words(K)``, for ``merge_items``.  Raises naming the bytes
    when these partials do not fit on the device (``alloc_or_raise``)."""
    from . import _cuda
    _, _, B = packed.shape
    nb = (packed if mesh is None else mesh.own).shape[0]
    if pold is not None:
        kk = pold.shape[1]
    C = items.length.shape[1]
    W = items.tiles.shape[1]
    for name, t, shape in (("tiles", items.tiles, (nb, W)),
                           ("start", items.start, (nb, C)),
                           ("length", items.length, (nb, C)),
                           ("order", items.order, (nb,))):
        _cuda.require(t, torch.int32, shape, name)
    G = nb * C
    dev = packed.device
    nacc = 8 + (N_SWARM if reso == "swarm" else 0)
    kw = keep_words(kk) if pold is not None else 0
    f32 = dict(dtype=torch.float32, device=dev)
    acc, ct, ci, keep = alloc_or_raise(
        f"the partials of {G} work items at K = {kk}",
        4 * G * B * (nacc + 2 * kk + kw),
        lambda: (torch.empty((nacc, G, B), **f32),
                 torch.empty((kk, G, B), **f32),
                 torch.empty((kk, G, B), dtype=torch.int32, device=dev),
                 torch.empty((G, kw, B), dtype=torch.int32, device=dev)
                 if kw else None))
    head = (packed.data_ptr(), nb, B, items.tiles.data_ptr(), W,
            items.start.data_ptr(), items.length.data_ptr(),
            items.order.data_ptr(), C)
    tail = (*kernel_floats(p), RESO_CODE[reso], kk)
    lib = _cuda.load("cd_tiles.cu")
    stream = _cuda.stream_ptr(dev)
    # the mesh form's arguments (struct Mesh); own null: one device
    mform = (0, 0, 1, 0, 0) if mesh is None else (
        mesh.own.data_ptr(), int(mesh.row0), int(mesh.rstride),
        int(mesh.col0), 0 if mesh.gid is None else mesh.gid.data_ptr())
    if cand is not None:
        if mesh is not None:
            raise ValueError("the candidate pass has no mesh form")
        rc = lib.cd_cand_items(*head, cand.data_ptr(), cand.shape[1], *tail,
                               acc.data_ptr(), ct.data_ptr(), ci.data_ptr(),
                               stream)
        _cuda.check(rc, "cd_cand_items")
    elif pold is None:
        rc = lib.cd_full_grid(*head, *tail, acc.data_ptr(), ct.data_ptr(),
                              ci.data_ptr(), *mform, stream)
        _cuda.check(rc, "cd_full_grid")
    else:
        rc = lib.cd_sched_tiles(*head, pold.data_ptr(), *tail,
                                acc.data_ptr(), ct.data_ptr(), ci.data_ptr(),
                                keep.data_ptr(), *mform, stream)
        _cuda.check(rc, "cd_sched_tiles")
    return acc, ct, ci, keep


def check_mesh(packed, mesh: MeshForm, pold=None, kk=KK, reso="mvp"):
    """Validate the operands of a mesh-form launch: the own-row slabs
    and ``pold`` as ``check_common`` holds them, the column slabs
    ``packed`` [ncols, _NF, B] and the table ``gid`` [ncols] int32.
    Returns ``(nbr, ncols, B)``."""
    from . import _cuda
    nbr, B = check_common(mesh.own, pold, kk=kk, reso=reso)
    ncols = packed.shape[0]
    _cuda.require(packed, torch.float32, (ncols, _NF, B), "packed")
    if mesh.gid is not None:
        _cuda.require(mesh.gid, torch.int32, (ncols,), "gid")
    if int(mesh.rstride) < 1:
        raise ValueError(f"rstride must be >= 1, got {mesh.rstride}")
    return nbr, ncols, B


def merge_items(parts, items, B, pold=None, reso="mvp"):
    """Launch ``cd_merge_items`` on the partials of ``walk_items`` (K the
    width of their top-K lists): returns the 13 outputs with ``pold``,
    else the 10, each followed by the ``N_SWARM`` swarm sums in the swarm
    form."""
    from . import _cuda
    acc_p, ct, ci, keep_p = parts
    nb, C = items.length.shape
    resume = pold is not None
    nacc, kk = acc_p.shape[0], ct.shape[0]
    outs = alloc_or_raise(
        f"the outputs of {nb} row blocks at K = {kk}",
        4 * nb * B * (nacc + 2 * kk + (2 * kk + 1 if resume else 0)),
        lambda: alloc_outputs(nb, kk, B, ct.device, resume=resume,
                              nacc=nacc))
    ptrs = [t.data_ptr() for t in outs] + [0] * (6 - len(outs))
    rc = _cuda.load("cd_tiles.cu").cd_merge_items(
        nb, B, C, kk, items.length.data_ptr(),
        pold.data_ptr() if resume else 0,
        acc_p.data_ptr(), ct.data_ptr(), ci.data_ptr(),
        keep_p.data_ptr() if resume else 0, *ptrs, RESO_CODE[reso],
        _cuda.stream_ptr(ct.device))
    _cuda.check(rc, "cd_merge_items")
    acc = list(outs[0].unbind(0))
    return acc[:8] + list(outs[1:]) + acc[8:]


def full_grid_resume(packed, reach, pold, p: TileParams,
                     per_row=RESUME_ITEMS_PER_ROW, reso="mvp",
                     mesh: MeshForm = None):
    """The sparse overflow-row fallback pass (``_kernel_resume``): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors (see
    ``full_grid_resume_plain``).  On the card each row's reachable tiles
    are cut into at most ``per_row`` work items (``reach_items``), walked
    by ``cd_sched_tiles`` and folded, with the partner merge, by
    ``cd_merge_items``; the items of a row that ``reach`` leaves empty
    exit at once.  Nothing waits for the device.  With ``mesh`` the row
    subset or halo window of ``full_grid_pass`` (``MeshForm``; ``reach``
    [nbr, ncols])."""
    if not packed.is_cuda:
        return full_grid_resume_plain(packed, reach, pold, p, reso, mesh)
    from . import _cuda
    if mesh is None:
        nb, B = check_common(packed, pold, reso=reso)
        ncols = reach.shape[1]
    else:
        nb, ncols, B = check_mesh(packed, mesh, pold, reso=reso)
    _cuda.require(reach, torch.bool, (nb, ncols), "reach")
    items = reach_items(reach, per_row, worlds=mesh is None)
    outs = merge_items(walk_items(packed, items, p, pold, reso=reso,
                                  mesh=mesh), items, B, pold, reso)
    LAUNCHES[launch_key("cd_full_grid_resume", reso,
                        None if mesh is None else mesh.kind)] += 1
    return outs


def full_grid(packed, reach, p: TileParams, per_row=ITEMS_PER_ROW,
              reso="mvp", kk=KK, mesh: MeshForm = None):
    """The reach-masked full-grid pass (``_kernel``): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors (see
    ``full_grid_plain``).  On the card each row's reachable tiles are cut
    into at most ``per_row`` work items (``reach_items``), walked by
    ``cd_full_grid`` and folded by ``cd_merge_items``; nothing waits for
    the device.  ``mesh`` as in ``full_grid_resume``."""
    if not packed.is_cuda:
        return full_grid_plain(packed, reach, p, reso, kk, mesh)
    from . import _cuda
    if mesh is None:
        nb, B = check_common(packed, kk=kk, reso=reso)
        ncols = reach.shape[1]
    else:
        nb, ncols, B = check_mesh(packed, mesh, kk=kk, reso=reso)
    _cuda.require(reach, torch.bool, (nb, ncols), "reach")
    items = reach_items(reach, per_row, worlds=mesh is None)
    parts = walk_items(packed, items, p, reso=reso, kk=kk, mesh=mesh)
    outs = merge_items(parts, items, B, reso=reso)
    LAUNCHES[launch_key("cd_full_grid", reso,
                        None if mesh is None else mesh.kind)] += 1
    return outs


def cand_tiles(packed, cand, p: TileParams, per_row=CAND_ITEMS_PER_ROW,
               reso="mvp", kk=KK):
    """The candidate-list pass (``_kernel_cand``): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors (see
    ``cand_tiles_plain``).  On the card each row's candidate sub-chunks
    are cut into at most ``per_row`` work items (``cand_items``), walked
    by ``cd_cand_items`` and folded by ``cd_merge_items``; nothing waits
    for the device.  No swarm form."""
    if reso == "swarm":
        raise ValueError("the candidate pass has no swarm form")
    if not packed.is_cuda:
        return cand_tiles_plain(packed, cand, p, reso, kk)
    from . import _cuda
    nb, B = check_common(packed, kk=kk, reso=reso)
    c_cap = cand.shape[1]
    if c_cap <= 0 or c_cap % B:
        raise ValueError(f"candidate capacity {c_cap} is not a positive "
                         f"multiple of the block {B}")
    _cuda.require(cand, torch.int32, (nb, c_cap), "cand")
    items = cand_items(cand, B, per_row)
    outs = merge_items(walk_items(packed, items, p, cand=cand, reso=reso,
                                  kk=kk), items, B, reso=reso)
    LAUNCHES[launch_key("cd_cand_tiles", reso)] += 1
    return outs


def build_candidates(lat, lon, gs, active, nb, block, c_cap, rpz,
                     tlookahead):
    """Per-ownship-block candidate aircraft (``_build_candidates``): a
    sub-block of ``CAND_SUB`` consecutive (Morton-sorted) slots is a
    candidate of row block i iff the conservative distance lower bound
    between their active bounding boxes is within ``rpz + tlookahead *
    (gsmax_row + gsmax_sub)`` (x1.05), the bound of
    ``block_reachability`` at sub-block granularity.  Candidate
    sub-blocks are compacted per row by a sort (ascending ids) and
    expanded to slot ids.

    Inputs are the padded sorted-space columns (``n = nb * block``).
    Returns ``(cand [nb, c_cap] int32, row_over [nb] bool)``: entries
    past a row's count hold the sentinel id ``n`` (the all-inactive
    column); an overflow row (more than ``c_cap`` candidates) is all
    sentinel and left to the full-grid pass."""
    sub = CAND_SUB
    n = lat.shape[0]
    nsb = n // sub
    c_sub = c_cap // sub
    dev = lat.device

    def boxes(shape):
        inf = torch.full((), float("inf"), dtype=lat.dtype, device=dev)
        zero = torch.zeros((), dtype=lat.dtype, device=dev)
        blat, blon = lat.reshape(shape), lon.reshape(shape)
        act = active.reshape(shape)
        return (torch.where(act, blat, inf).amin(1),
                torch.where(act, blat, -inf).amax(1),
                torch.where(act, blon, inf).amin(1),
                torch.where(act, blon, -inf).amax(1),
                torch.where(act, gs.reshape(shape), zero).amax(1),
                act.any(1))

    rlatmin, rlatmax, rlonmin, rlonmax, rgsmax, _ = boxes((nb, block))
    slatmin, slatmax, slonmin, slonmax, sgsmax, s_any = boxes((nsb, sub))
    r_abslat = torch.maximum(torch.abs(rlatmin), torch.abs(rlatmax))
    s_abslat = torch.maximum(torch.abs(slatmin), torch.abs(slatmax))

    # [nb, nsb] box-to-box gaps: meridional < 110 km/deg, zonal from the
    # smallest meridian spacing at the larger |lat|, circular longitude
    dlat_gap = torch.clamp_min(torch.maximum(
        rlatmin[:, None] - slatmax[None, :],
        slatmin[None, :] - rlatmax[:, None]), 0.0)
    lin_gap = torch.clamp_min(torch.maximum(
        rlonmin[:, None] - slonmax[None, :],
        slonmin[None, :] - rlonmax[:, None]), 0.0)
    wrap_gap = torch.clamp_min(360.0 - (
        torch.maximum(rlonmax[:, None], slonmax[None, :])
        - torch.minimum(rlonmin[:, None], slonmin[None, :])), 0.0)
    dlon_gap = torch.minimum(lin_gap, wrap_gap)
    cos_lb = torch.cos(geo.radians(torch.clamp_max(
        torch.maximum(r_abslat[:, None], s_abslat[None, :]), 90.0)))
    zonal = 2.0 * 6335000.0 * torch.asin(torch.clamp(
        cos_lb * torch.sin(geo.radians(0.5 * torch.clamp_max(dlon_gap,
                                                             360.0))),
        0.0, 1.0))
    dist_lb = torch.maximum(dlat_gap * 110000.0, zonal)
    thresh = rpz + tlookahead * (rgsmax[:, None] + sgsmax[None, :])
    mask = (dist_lb <= thresh * 1.05) & s_any[None, :]

    row_over = mask.sum(1) > c_sub
    key = torch.where(mask, torch.arange(nsb, dtype=torch.int32,
                                         device=dev)[None, :],
                      torch.full((), _BIG_I, dtype=torch.int32, device=dev))
    cand_sub = torch.sort(key, dim=1).values[:, :c_sub]       # [nb, c_sub]
    valid = (cand_sub < _BIG_I) & ~row_over[:, None]
    cand = torch.where(valid, cand_sub, 0)[:, :, None] * sub \
        + torch.arange(sub, dtype=torch.int32, device=dev)[None, None, :]
    cand = torch.where(valid[:, :, None], cand,
                       torch.full((), n, dtype=torch.int32, device=dev))
    return cand.reshape(nb, c_sub * sub).contiguous(), row_over


class PallasInputs(NamedTuple):
    """The kernel operands of one pallas-backend pass (sorted space).  A
    stack of W worlds stacks the slabs along the row-block axis: row
    block w * nb + i is world w's block i."""
    packed: torch.Tensor      # [W * nb, 16, B] f32 slabs (_FIELDS)
    reach: torch.Tensor       # [W * nb, nb] bool block reachability
    lat: torch.Tensor         # [W, nb*B] f32 padded columns of the
    lon: torch.Tensor         # candidate bound ([nb*B] for one world)
    gs: torch.Tensor
    active: torch.Tensor      # [W, nb*B] bool
    n: int                    # caller's aircraft count (per world)
    nb: int                   # row blocks per world
    block: int
    reso: str = "mvp"         # the tile body's resolver form
    worlds: int = 1


def tr_row(gs, extra_cols=None, reso="mvp"):
    """The overloaded ``tr`` slab row (float32): the CAS under Swarm
    (``extra_cols["cas"]``, else gs), else the tas/gs ratio of Eby's
    velocity basis (``tr * u = tas * sin(trk)``; gs floored at 0.5), 1
    when no tas is given."""
    gs = gs.to(torch.float32)
    extra_cols = extra_cols or {}
    if reso == "swarm":
        return extra_cols.get("cas", gs).to(torch.float32)
    if "tas" not in extra_cols:
        return torch.ones_like(gs)
    return extra_cols["tas"].to(torch.float32) / torch.clamp_min(gs, 0.5)


def prepare(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active, noreso,
            rpz, tlookahead, block=256, extra_cols=None,
            reso="mvp") -> PallasInputs:
    """Packed float32 slabs and block reachability of already sorted
    columns, padded to whole blocks: ``block`` capped at 256 and at the
    power of two that covers ``n``, 128 for ``n <= 128``.  ``reso`` and
    ``extra_cols`` (``tas`` or ``cas``) fill the ``tr`` row
    (``tr_row``); Swarm widens the reachability to its neighbourhood.
    Columns with a leading world axis [W, n] give the stacked operands
    of every world (``PallasInputs``)."""
    dtype = torch.float32
    lead = lat.shape[:-1]
    n = lat.shape[-1]
    block = 128 if n <= 128 else min(block, 256, 1 << (n - 1).bit_length())
    nb = -(-n // block)
    npad = nb * block - n

    def pad(a):
        a = a.to(dtype)
        return a if npad == 0 else torch.cat([a, a.new_zeros(*lead, npad)],
                                             -1)

    gs32 = gs.to(dtype)
    trkrad = geo.radians(trk.to(dtype))
    fields = precompute_trig(pad(lat), pad(lon))
    fields.update({
        "u": pad(gs32 * torch.sin(trkrad)), "v": pad(gs32 * torch.cos(trkrad)),
        "alt": pad(alt), "vs": pad(vs), "gse": pad(gseast),
        "gsn": pad(gsnorth), "trk": pad(trk),
        "tr": pad(tr_row(gs32, extra_cols, reso)),
        "active": pad(active), "noreso": pad(noreso)})
    packed = torch.stack([fields[k] for k in _FIELDS]).reshape(
        _NF, -1, block).transpose(0, 1).contiguous()
    act = fields["active"] > 0.5
    reach = block_reachability(
        fields["lat"], fields["lon"], pad(gs), act, nb, block, float(rpz),
        float(tlookahead),
        min_reach_m=cr_swarm.R_SWARM if reso == "swarm" else 0.0)
    return PallasInputs(packed=packed, reach=reach.reshape(-1, nb),
                        lat=fields["lat"], lon=fields["lon"], gs=pad(gs),
                        active=act, n=n, nb=nb, block=block, reso=reso,
                        worlds=int(np.prod(lead, dtype=np.int64)))


def shard_devices(mesh):
    """The devices of a mesh in shard order (row-major over its axes); a
    device may repeat."""
    return [torch.device(d) for d in np.asarray(mesh.devices).ravel()]


def mesh_shards(mesh):
    """``(devices, ranks, guard)`` of a mesh: its devices in shard order
    (``shard_devices``), the process that owns each shard and the
    ``MeshGuard`` its joins across processes wait through (or None)."""
    return (shard_devices(mesh), [int(r) for r in mesh.ranks.ravel()],
            mesh.guard)


def on_device(dev):
    """Make ``dev`` the current CUDA device for a shard's launches (the
    kernels launch on the current stream of the tensors' device)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def split_rows(nb, devs, home, run, ranks=None, guard=None):
    """The replicate row split (JAX ``run_full_sharded``): shard d walks
    the row blocks d, d + D, ... below ``nb`` (its part of
    ``interleave_rows``, made on ``home`` so that nothing waits for a
    host copy) on its device ``devs[d]``.  ``run(d, rows, dev)`` gives
    shard d's outputs for the row blocks ``rows`` (int64 on ``home``);
    returns them placed back in row order on ``home``, in kernel
    layout.  With ``ranks`` (the owner of each shard) spanning processes
    this process runs only its own shards and the outputs of every shard
    are all-gathered, each padded to ``ceil(nb / D)`` rows
    (``parallel/dist.allgather_shards``, waiting through ``guard``); every
    process must own a shard below ``nb``."""
    D = len(devs)
    me = process_index()
    ranks = [me] * D if ranks is None else list(ranks)
    across = spans_ranks(ranks)
    if across and any(ranks.index(q) >= nb for q in set(ranks)):
        raise ValueError(f"{nb} row blocks leave a process of the {D}-shard "
                         "mesh without rows")
    rmax = -(-nb // D)
    local = {}
    for d, dev in enumerate(devs):
        rows = torch.arange(d, nb, D, device=home)
        if rows.numel() == 0 or ranks[d] != me:
            continue
        with on_device(dev):
            o = run(d, rows, dev)
        if across:
            o = [torch.cat([a.to(home), a.new_zeros(
                (rmax - a.shape[0], *a.shape[1:]), device=home)])
                for a in o]
        local[d] = o
    if across:
        # a shard past the last row block sends zeros of its peers' shape
        like = next(iter(local.values()))
        for d in range(D):
            if ranks[d] == me and d not in local:
                local[d] = [torch.zeros_like(a) for a in like]
        local = allgather_shards(local, ranks, home, guard)
    outs = None
    for d in sorted(local):
        rows = torch.arange(d, nb, D, device=home)
        o = local[d]
        if outs is None:
            outs = [a.new_empty((nb, *a.shape[1:]), device=home) for a in o]
        for a, b in zip(outs, o):
            a[rows] = b[:rows.numel()].to(home)
    return outs


def full_grid_rows(x: PallasInputs, p: TileParams, devs, kk=KK,
                   ranks=None, guard=None):
    """The replicate row split of the full grid (``split_rows``, over the
    shards' ``ranks``) against the replicated slabs in the row-subset
    form.  Returns the outputs in kernel layout."""
    def run(d, rows, dev):
        return full_grid(
            x.packed.to(dev), x.reach[rows].to(dev), p, reso=x.reso, kk=kk,
            mesh=MeshForm(own=x.packed[rows].to(dev), row0=d,
                          rstride=len(devs)))
    return split_rows(x.nb, devs, x.packed.device, run, ranks, guard)


def run_kernels(x: PallasInputs, p: TileParams, cand_cap=0, kk=KK,
                devs=None, ranks=None, guard=None):
    """The pass of ``detect_resolve_pallas`` on prepared operands, in the
    resolver form ``x.reso`` with top-``kk`` candidates: the full grid,
    or with ``cand_cap > 0`` (rounded up to whole blocks) and at least 8
    row blocks the candidate pass plus the full grid over its overflow
    rows, merged row-disjointly.  The full grid is launched on ``reach &
    row_over`` whether or not a row overflowed, so nothing waits for the
    device.  Returns the outputs in kernel layout.  A stack of worlds
    runs the full grid, one launch for all of them (candidate mode takes
    one world).  With the devices ``devs`` of a mesh of more than one
    shard the full grid's replicate row split runs instead
    (``full_grid_rows``, over the shards' ``ranks``), as in JAX, whatever
    ``cand_cap``."""
    if devs is not None and len(devs) > 1:
        if x.worlds > 1:
            raise ValueError("a stack of worlds takes no mesh")
        return full_grid_rows(x, p, devs, kk, ranks, guard)
    c_cap = -(-cand_cap // x.block) * x.block if cand_cap else 0
    if not (x.nb >= 8 and 0 < c_cap < x.nb * x.block):
        return full_grid(x.packed, x.reach, p, reso=x.reso, kk=kk)
    if x.worlds > 1:
        raise ValueError("candidate mode (cand_cap > 0) takes one world")
    cand, row_over = build_candidates(
        x.lat, x.lon, x.gs, x.active, x.nb, x.block, c_cap, p.rpz,
        p.tlookahead)
    outs_c = cand_tiles(x.packed, cand, p, reso=x.reso, kk=kk)
    outs_f = full_grid(x.packed, x.reach & row_over[:, None], p,
                       reso=x.reso, kk=kk)
    rsel = row_over[:, None, None]
    return [torch.where(rsel, f, c) for f, c in zip(outs_f, outs_c)]


def detect_resolve_pallas(lat, lon, trk, gs, alt, vs, gseast, gsnorth,
                          active, noreso, rpz, hpz, tlookahead, mvpcfg,
                          block=256, k_partners=KK, cand_cap=0, perm=None,
                          extra_cols=None, reso="mvp", mesh=None,
                          mesh_axis="ac", spatial_sort=True):
    """CD&R of the ``pallas`` backend; returns a ``RowConflictData`` in
    caller order (``topk_idx`` caller slots, -1 empty), and with
    ``reso="swarm"`` ``(rd, swarm_sums)``.  Always float32.

    With more slots than ``block`` the pass runs in Morton-sorted slot
    space (``cd_tiled.run_spatially_sorted``, ``perm`` a cached sorted ->
    caller permutation, recomputed when None); ``spatial_sort=False``
    runs it in caller order (``perm`` unread), as JAX's does: the
    reachability then skips only what the caller's order leaves apart.  ``cand_cap > 0`` turns on
    the candidate-list scheduler (see ``run_kernels``); the result is the
    same either way.  ``reso`` is the tile body's resolver form, with
    ``extra_cols`` its ``tas`` (Eby) or ``cas`` (Swarm) column.  The
    partner candidates are the ``k_partners`` most urgent, as JAX's
    (the tiled backend alone keeps ``min(k_partners, block)``), at any
    width the device's memory holds.  A ``mesh``
    (``parallel/sharding.py``) of more than one shard on ``mesh_axis``
    splits the full grid's rows over its devices (``full_grid_rows``);
    the result is the same.

    Columns with a leading world axis [W, N] (and ``perm`` [W, N]) run W
    worlds in one pass, each kernel launched once for the stack; the
    result has the leading axis too (``nconf``/``nlos`` [W]), with
    world-local partner ids."""
    if reso == "swarm" and cand_cap:
        raise ValueError("cand_cap mixed mode does not carry the swarm "
                         "neighbour sums; use cand_cap=0 with RESO SWARM")
    if reso not in RESO_CODE:
        raise ValueError(f"unknown resolver form {reso!r}; expected one of "
                         f"{tuple(RESO_CODE)}")
    args = (lat, lon, trk, gs, alt, vs, gseast, gsnorth, active, noreso,
            rpz, hpz, tlookahead, mvpcfg)
    shards = (None, None, None)
    if mesh is not None and dict(mesh.shape).get(mesh_axis, 1) > 1:
        shards = mesh_shards(mesh)
    kw = dict(block=block, k_partners=k_partners, cand_cap=cand_cap,
              reso=reso, shards=shards)
    if spatial_sort and lat.shape[-1] > block:
        return cd_tiled.run_spatially_sorted(
            _detect_resolve_sorted, *args, perm=perm, extra_cols=extra_cols,
            **kw)
    return _detect_resolve_sorted(*args, extra_cols=extra_cols, **kw)


def _detect_resolve_sorted(lat, lon, trk, gs, alt, vs, gseast, gsnorth,
                           active, noreso, rpz, hpz, tlookahead, mvpcfg,
                           block, k_partners, cand_cap, reso,
                           extra_cols=None, shards=(None, None, None)):
    """``detect_resolve_pallas`` on columns already in the slot order the
    pass runs in; ``topk_idx`` holds slots of that order (of its own
    world, for a stack of worlds)."""
    lead = lat.shape[:-1]
    n = lat.shape[-1]
    x = prepare(lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
                noreso, rpz, tlookahead, block=block, extra_cols=extra_cols,
                reso=reso)
    kk = k_partners
    outs = run_kernels(x, tile_params(rpz, hpz, tlookahead, mvpcfg),
                       cand_cap, kk, *shards)
    (inconf, tcpamax, sdve, sdvn, sdvv, tsolv, ncnt, lcnt,
     ctin, cidx) = outs[:10]
    nt = x.nb * x.block
    unb = lambda a: a.reshape(*lead, nt)[..., :n]
    topk_tin = ctin.transpose(1, 2).reshape(*lead, nt, kk)[..., :n, :]
    topk_idx = cidx.transpose(1, 2).reshape(*lead, nt, kk)[..., :n, :]
    if lead:        # the kernels' slot ids are global: back to the world's
        off = torch.arange(x.worlds, device=cidx.device, dtype=torch.int32)
        topk_idx = topk_idx - (off * nt).reshape(*lead, 1, 1)
    topk_idx = torch.where(topk_tin < _BIG, topk_idx,
                           torch.full_like(topk_idx, -1))
    rd = RowConflictData(
        inconf=unb(inconf) > 0.5, tcpamax=unb(tcpamax),
        sum_dve=unb(sdve), sum_dvn=unb(sdvn), sum_dvv=unb(sdvv),
        tsolv=unb(tsolv),
        # per-block float counts cast to int32 before summing: an f32
        # total loses exactness past 2^24 pairs
        nconf=ncnt.to(torch.int32).reshape(*lead, -1).sum(-1,
                                                           dtype=torch.int32),
        nlos=lcnt.to(torch.int32).reshape(*lead, -1).sum(-1,
                                                         dtype=torch.int32),
        topk_idx=topk_idx, topk_tin=topk_tin)
    if reso == "swarm":
        return rd, tuple(unb(a) for a in outs[10:10 + N_SWARM])
    return rd
