"""The work items and the row merge of the split walkers (``cd_full_grid``,
``cd_sched_tiles`` on segment blocks and on overflow rows,
``cd_cand_items``), on the CPU:

* ``cd_pallas.work_items`` (through ``reach_items``, ``cand_items`` and
  ``cd_sched.window_items``) covers every reachable tile, every
  scheduled segment block, or every candidate sub-chunk that holds an
  id, exactly once and in ascending order within a row, with no item
  longer than ``ceil(r / C)`` tiles and no row cut into more than ``C``
  items;
* ``cd_pallas.merge_items_plain``, the plain version of the merge kernel
  ``cd_merge_items``, run on the ``row_block_plain`` outputs of a row's
  items, equals the whole row's plain pass: flags, counts, keep bits,
  merged partners and the top-K ids in order exactly, the float
  reductions within rtol 1e-4 / atol 5e-3 (the items add their sums in
  another order), for the resume body (segments, overflow rows) and the
  plain one (reachable blocks, candidate sub-chunks).
"""
import numpy as np
import pytest
import torch

from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled, cr_mvp

from torch_parity import FT, NM

N = 1536
BLOCK = 64
RPZ, HPZ, TLOOK = 5 * NM, 1000 * FT, 300.0
GEOMS = ["continental", "regional", "equator", "clusters"]


def columns(geom, seed=2, t_ahead=0.0):
    """detect_resolve_* operand columns (float32 / bool CPU tensors) of
    one geometry, positions moved ``t_ahead`` seconds along the tracks."""
    rng = np.random.default_rng(seed)
    if geom == "clusters":
        centers = np.array([(45 + 5 * (i // 4), -5 + 5 * (i % 4))
                            for i in range(8)])[rng.integers(0, 8, N)]
        lat = centers[:, 0] + rng.normal(0, 0.3, N)
        lon = centers[:, 1] + rng.normal(0, 0.4, N)
    elif geom == "regional":
        ang = rng.uniform(0, 2 * np.pi, N)
        r = 1.5 * np.sqrt(rng.random(N))
        lat, lon = 52.6 + r * np.cos(ang), 5.4 + r * np.sin(ang) / 0.6
    elif geom == "equator":
        lat, lon = rng.uniform(-3.0, 3.0, N), rng.uniform(-4.0, 4.0, N)
    else:
        lat, lon = rng.uniform(45.0, 58.0, N), rng.uniform(-5.0, 15.0, N)
    gs, trk = rng.uniform(130.0, 240.0, N), rng.uniform(0.0, 360.0, N)
    gse, gsn = gs * np.sin(np.radians(trk)), gs * np.cos(np.radians(trk))
    lat = lat + gsn * t_ahead / 111320.0
    lon = lon + gse * t_ahead / (111320.0 * np.cos(np.radians(lat)))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return [f(lat), f(lon), f(trk), f(gs), f(rng.uniform(8000, 11000, N)),
            f(rng.uniform(-8, 8, N)), f(gse), f(gsn),
            torch.as_tensor(rng.random(N) > 0.05),
            torch.as_tensor(rng.random(N) > 0.9)]


def _mvp():
    return cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                            tlookahead=TLOOK)


def sched_inputs(geom, s_cap=6):
    """The segment pass's operands of the second of two intervals: the
    partner table is the first interval's merged one, the fleet moved
    20 s, so the keep bits decide real old partners."""
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(), RPZ * 1.05)
    n_tot = cd_sched.padded_size(N, BLOCK)
    table = torch.full((n_tot, 8), -1, dtype=torch.int32)
    x = cd_sched.prepare(*columns(geom), RPZ, HPZ, TLOOK, table,
                         block=BLOCK, s_cap=s_cap)
    first = cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                       x.pold, p)
    table = first[11].transpose(1, 2).reshape(n_tot, 8).contiguous()
    x = cd_sched.prepare(*columns(geom, t_ahead=20.0), RPZ, HPZ, TLOOK,
                         table, block=BLOCK, s_cap=s_cap, perm=x.perm)
    return x, p


def pallas_inputs(geom):
    cols = columns(geom)
    perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8])
    x = cd_pallas.prepare(*[a[perm] for a in cols], RPZ, TLOOK, block=BLOCK)
    return x, cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp())


def reach_rows(reach):
    rh = reach.numpy()
    return [np.flatnonzero(r) for r in rh]


def window_rows(x):
    st, ln = x.wst.numpy(), np.minimum(x.wln.numpy(), x.wmax)
    rows = []
    for i in range(x.nb):
        t = np.concatenate([np.arange(b, b + k) for b, k in zip(st[i], ln[i])]
                           + [np.zeros(0, np.int64)])
        rows.append(t[t < x.nb])
    return rows


def assert_items_cover(items, rows, per_row):
    """Every row's items, in item order, are exactly its tiles; no item
    is longer than ceil(r / C), no row has more than C items, the
    non-empty items come first and the launch order is a permutation of
    the rows by non-increasing item length."""
    tiles = items.tiles.numpy()
    start, length = items.start.numpy(), items.length.numpy()
    assert length.shape == (len(rows), per_row)
    for i, want in enumerate(rows):
        r = len(want)
        got = np.concatenate(
            [tiles[i, start[i, k]:start[i, k] + length[i, k]]
             for k in range(per_row) if length[i, k] > 0]
            + [np.zeros(0, np.int32)])
        np.testing.assert_array_equal(got, want)
        assert (np.diff(got) > 0).all()
        assert length[i].max(initial=0) <= max(-(-r // per_row), 1)
        nonempty = length[i] > 0
        assert nonempty.sum() <= per_row
        assert not (np.diff(nonempty.astype(int)) > 0).any()
    order = items.order.numpy()
    assert sorted(order.tolist()) == list(range(len(rows)))
    assert (np.diff(length[order, 0]) <= 0).all()


@pytest.mark.parametrize("per_row", [8, 2])
@pytest.mark.parametrize("geom", GEOMS)
def test_reach_items_cover_every_tile(geom, per_row):
    x, _ = pallas_inputs(geom)
    items = cd_pallas.reach_items(x.reach, per_row)
    rows = reach_rows(x.reach)
    assert max(len(r) for r in rows) > per_row    # some rows split
    assert_items_cover(items, rows, per_row)


@pytest.mark.parametrize("per_row", [6, 2])
@pytest.mark.parametrize("geom", GEOMS)
def test_window_items_cover_every_segment_block(geom, per_row):
    x = cd_sched.prepare(*columns(geom), RPZ, HPZ, TLOOK,
                         torch.full((cd_sched.padded_size(N, BLOCK), 8), -1,
                                    dtype=torch.int32),
                         block=BLOCK)
    items = cd_sched.window_items(x.wst, x.wln, x.wmax, x.nb, per_row)
    rows = window_rows(x)
    assert max(len(r) for r in rows) > per_row
    assert_items_cover(items, rows, per_row)


@pytest.mark.parametrize("per_row", [1, 3, 8])
def test_items_of_short_rows(per_row):
    """Rows with 0, 1, C - 1, C, C + 1 and 3C tiles, and a row of all."""
    nb = 24
    rng = np.random.default_rng(per_row)
    reach = np.zeros((7, nb), bool)
    for i, r in enumerate([0, 1, max(per_row - 1, 0), per_row, per_row + 1,
                           3 * per_row]):
        reach[i, rng.choice(nb, r, replace=False)] = True
    reach[6] = True
    reach = torch.as_tensor(reach)
    items = cd_pallas.reach_items(reach, per_row)
    assert_items_cover(items, reach_rows(reach), per_row)
    assert int(items.length[0].sum()) == 0      # the empty row goes last
    assert int(items.length[int(items.order[-1])].sum()) == 0


def merge_rows(packed, items, pold, p, cand=None):
    """``merge_items_plain`` over the ``row_block_plain`` outputs of every
    row's items, in the kernels' layout (that of ``rows_plain``).  A tile
    is an intruder block, or with ``cand`` a sub-chunk of B entries of
    the row's candidate table."""
    nb, _, B = packed.shape
    allf = torch.cat([packed.transpose(0, 1).reshape(cd_pallas._NF, nb * B),
                      packed.new_zeros((cd_pallas._NF, 1))], 1)
    lane = torch.arange(B)
    tiles = items.tiles.numpy()
    start, length = items.start.numpy(), items.length.numpy()
    rows, splits = [], 0
    for i in range(nb):
        po = None if pold is None else pold[i]
        parts = []
        for k in range(length.shape[1]):
            if length[i, k] > 0:
                t = tiles[i, start[i, k]:start[i, k] + length[i, k]]
                ids = (cd_pallas.block_ids(t, B) if cand is None else
                       cand[i, int(t[0]) * B:(int(t[-1]) + 1) * B].long())
                parts.append(cd_pallas.row_block_plain(
                    packed[i], allf[:, ids], i * B + lane, ids, po, p))
        splits += len(parts) > 1
        rows.append(cd_pallas.merge_items_plain(parts, B, po))
    outs = [torch.stack(parts) for parts in zip(*rows)]
    for j in list(range(8)) + ([12] if pold is not None else []):
        outs[j] = outs[j][:, None, :]
    return outs, splits


def assert_merge_equal(got, want):
    exact = [0, 6, 7, 8, 9] + ([10, 11, 12] if len(want) > 10 else [])
    for j in exact:
        assert torch.equal(got[j], want[j]), f"output {j} differs"
    for j in (1, 2, 3, 4, 5):
        torch.testing.assert_close(got[j], want[j], rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("per_row", [8, 2])
@pytest.mark.parametrize("geom", GEOMS)
def test_merge_of_items_equals_whole_rows_resume(geom, per_row):
    """The ``cd_sched_tiles`` form: keep predicate, keep bits, partner
    merge, on the segment blocks."""
    x, p = sched_inputs(geom)
    items = cd_sched.window_items(x.wst, x.wln, x.wmax, x.nb, per_row)
    got, splits = merge_rows(x.packed, items, x.pold, p)
    want = cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                      x.pold, p)
    assert splits > 0
    assert int(want[6].sum()) > 0 and int(want[10].sum()) > 0
    assert_merge_equal(got, want)


@pytest.mark.parametrize("per_row", [8, 2])
@pytest.mark.parametrize("geom", GEOMS)
def test_merge_of_items_equals_whole_rows(geom, per_row):
    """The ``cd_full_grid`` form: every conflict pair a candidate, on the
    reachable tiles in Morton order."""
    x, p = pallas_inputs(geom)
    items = cd_pallas.reach_items(x.reach, per_row)
    got, splits = merge_rows(x.packed, items, None, p)
    want = cd_pallas.full_grid_plain(x.packed, x.reach, p)
    assert splits > 0 and int(want[6].sum()) > 0
    assert_merge_equal(got, want)


def cand_inputs(cap):
    """The eight clusters in Morton order and their candidate table of
    capacity ``cap``; some rows fit it and some overflow."""
    x, p = pallas_inputs("clusters")
    cand, row_over = cd_pallas.build_candidates(
        x.lat, x.lon, x.gs, x.active, x.nb, x.block, cap, RPZ, TLOOK)
    assert 0 < int(row_over.sum()) < x.nb
    return x, p, cand


def cand_rows(cand, B):
    """Row i's sub-chunks that hold an id: ``0 .. ceil(count / B) - 1``,
    the table being ascending ids, then the sentinel ``nb * B``."""
    c = cand.numpy()
    nb = c.shape[0]
    rows = []
    for r in c:
        count = int((r < nb * B).sum())
        assert (r[:count] < nb * B).all() and (r[count:] == nb * B).all()
        assert (np.diff(r[:count]) > 0).all()
        rows.append(np.arange(-(-count // B)))
    return rows


@pytest.mark.parametrize("per_row", [8, 2])
@pytest.mark.parametrize("cap", [256, 512])
def test_cand_items_cover_every_sub_chunk(cap, per_row):
    x, _, cand = cand_inputs(cap)
    items = cd_pallas.cand_items(cand, BLOCK, per_row)
    rows = cand_rows(cand, BLOCK)
    assert items.tiles.shape == (x.nb, cap // BLOCK)
    assert max(len(r) for r in rows) > 1          # some rows split
    assert min(len(r) for r in rows) == 0         # an overflow row
    assert_items_cover(items, rows, per_row)


@pytest.mark.parametrize("per_row", [1, 3, 8])
def test_cand_items_of_short_rows(per_row):
    """Rows of 0, 1, C - 1, C, C + 1 and 3C sub-chunks, the last one
    partly sentinel in every other row, and empty rows after them."""
    nb, B = 3 * per_row + 6, 32
    w = 3 * per_row
    sentinel = nb * B
    cand = np.full((nb, w * B), sentinel, np.int32)
    rng = np.random.default_rng(per_row)
    for i, r in enumerate([0, 1, max(per_row - 1, 0), per_row, per_row + 1,
                           3 * per_row]):
        count = r * B - (B // 2 if r and i % 2 else 0)
        cand[i, :count] = np.sort(rng.choice(sentinel, count, replace=False))
    cand = torch.as_tensor(cand)
    items = cd_pallas.cand_items(cand, B, per_row)
    assert_items_cover(items, cand_rows(cand, B), per_row)
    assert int(items.length[0].sum()) == 0
    assert int(items.length[int(items.order[-1])].sum()) == 0


@pytest.mark.parametrize("per_row", [8, 2])
@pytest.mark.parametrize("cap", [256, 512])
def test_merge_of_cand_items_equals_whole_rows(cap, per_row):
    """The ``cd_cand_items`` form: every conflict pair a candidate, on the
    sub-chunks of each row's candidate table."""
    x, p, cand = cand_inputs(cap)
    items = cd_pallas.cand_items(cand, BLOCK, per_row)
    got, splits = merge_rows(x.packed, items, None, p, cand=cand)
    want = cd_pallas.cand_tiles_plain(x.packed, cand, p)
    assert splits > 0 and int(want[6].sum()) > 0
    assert_merge_equal(got, want)


@pytest.mark.parametrize("per_row", [8, 2])
@pytest.mark.parametrize("s_cap", [1, 2])
def test_merge_of_overflow_items_equals_whole_rows(s_cap, per_row):
    """The ``_kernel_resume`` form: ``cd_sched_tiles`` and the partner
    merge on the reachable blocks of the regional clump's overflow rows
    (``s_cap`` small enough that some rows overflow)."""
    x, p = sched_inputs("regional", s_cap=s_cap)
    assert int(x.overflow.sum()) > 0
    reach_f = x.reach & x.overflow[:, None]
    items = cd_pallas.reach_items(reach_f, per_row)
    got, splits = merge_rows(x.packed, items, x.pold, p)
    want = cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold, p)
    assert splits > 0
    assert int(want[6].sum()) > 0 and int(want[10].sum()) > 0
    assert_merge_equal(got, want)
