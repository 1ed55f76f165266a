"""The port at the JAX package's largest fleets, on the CPU: the fleets
``bench.py`` makes (``_make_traffic``: numpy seed 0, B744, the global and
the 230 nm regional draws in its order) and the path JAX wrote for them.

* The sparse schedule's host structures at a million aircraft worldwide:
  ``reach_threshold_m``, ``stripe_sort_dest`` and the block reachability
  and segment windows of ``cd_sched.prepare`` bit-equal to JAX's
  functions of the same names, and every work item of ``window_items``
  inside its row and the grid.
* JAX's row-split path (``detect_resolve_sched`` past
  ``_ONE_VARIANT_ROWS`` row blocks: one kernel variant, the grid cut
  into ``_MAX_ROWS``-row ``pallas_call``s), forced at a small size by
  setting the two module constants, against the port's one launch over
  every row block: flags, counts and top-K sets equal, sums within the
  float32 bound of ``tests/test_torch_cd_sched.py`` (rtol 1e-4, atol
  5e-3), partner sets and engagement flags equal, with the partner table
  fresh and resumed.  A row whose float32 sums part the packages (the
  resumed "global" case has one, row 116: an ill-conditioned pair,
  ROADMAP §C) is held to a float64 witness instead, the port no further
  from it than JAX.
* bench's two generators run whole at N = 256: three 20-step chunks
  (3 simulated seconds, a sort refresh before each, as ``bench.run_one``
  drives JAX) on the sparse and the pallas backend against JAX's
  ``run_steps``, at the float32 bounds of ``tests/test_torch_slice.py``.
* ``Traffic.flush`` of several types at once fills the performance
  columns as JAX's does (the port fills them a type at a time).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from bluesky_tpu.core import asas as jasas, step as jstep
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu.ops import cd_sched as jsched, cd_tiled as jtiled, \
    cr_mvp as jmvp
from bluesky_tpu_torch.core import asas as tasas, step as tstep
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic, \
    _np_vcasormach
from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp

from torch_parity import (FT, NM, jax_tree_to_numpy, partner_sets,
                          slab64)

RPZ, HPZ, TLOOK = 5 * NM, 1000 * FT, 300.0


def bench_draws(n, geometry):
    """``bench._make_traffic``'s creation inputs: its seed, its draws in
    its order.  Returns ``(lat, lon, alt, spd, hdg)``."""
    rng = np.random.default_rng(0)
    if geometry == "global":
        lat = np.degrees(np.arcsin(rng.uniform(-0.94, 0.94, n)))
        lon = rng.uniform(-180.0, 180.0, n)
    else:
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 3.8 * np.sqrt(rng.random(n))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    return (lat, lon, rng.uniform(3000.0, 11000.0, n),
            rng.uniform(130.0, 240.0, n), rng.uniform(0.0, 360.0, n))


# ---------------------------------------- the schedule at a million aircraft

#: bench's largest fleet (``bench.py`` ``detail()``)
N_MILLION = 1_000_000


@pytest.fixture(scope="module")
def million():
    """The CD columns of bench's million aircraft worldwide at creation
    (float32): the ground speed the port's ``Traffic.flush`` sets (the
    TAS of the speed draw at the altitude draw), the track the heading,
    no vertical speed, every aircraft active.  Then the port's sparse
    operands (``cd_sched.prepare``, block 256) and JAX's stripe sort,
    reachability and windows of the same columns."""
    lat, lon, alt, spd, hdg = bench_draws(N_MILLION, "global")
    gs = _np_vcasormach(spd, alt)[0]
    trk = np.radians(hdg)
    f = lambda a: np.asarray(a, np.float32)
    cols = [f(lat), f(lon), f(hdg), f(gs), f(alt), np.zeros(N_MILLION,
                                                             np.float32),
            f(gs * np.sin(trk)), f(gs * np.cos(trk)),
            np.ones(N_MILLION, bool), np.zeros(N_MILLION, bool)]
    x = cd_sched.prepare(*[torch.from_numpy(a) for a in cols], RPZ, HPZ,
                         TLOOK, None, block=256)
    thresh_t = cd_sched.reach_threshold_m(torch.from_numpy(cols[3]),
                                          torch.from_numpy(cols[8]), TLOOK,
                                          RPZ)
    nb, n_tot = x.nb, x.n_tot

    @jax.jit
    def schedule(lat, lon, gs, alt, vs, active):
        thresh = jsched.reach_threshold_m(gs, active, TLOOK, RPZ)
        dest = jsched.stripe_sort_dest(lat, lon, gs, active, thresh, 256,
                                       32)
        plat, plon, pgs, palt, pvs, pact = jsched.scatter_padded(
            [lat, lon, gs, alt, vs, active.astype(jnp.float32)], dest,
            n_tot)
        reach = jtiled.block_reachability(
            plat, plon, pgs, pact > 0.5, nb, 256, RPZ, TLOOK, alt=palt,
            vs=pvs, hpz=HPZ)
        st, ln, over = jsched.build_windows(reach, 6, 16, pad_start=nb)
        return thresh, dest, reach, jnp.clip(st, 0, nb), ln, over

    j = [np.asarray(a) for a in schedule(*(jnp.asarray(cols[k])
                                            for k in (0, 1, 3, 4, 5, 8)))]
    return dict(x=x, thresh=thresh_t, jax=dict(zip(
        ("thresh", "dest", "reach", "wst", "wln", "overflow"), j)))


def test_million_sort_and_windows_match_jax(million):
    """The stripe sort, the reachability and the segment windows of a
    million aircraft worldwide equal JAX's bit for bit."""
    x, j = million["x"], million["jax"]
    assert x.nb == -(-N_MILLION // 256) + 32
    assert np.asarray(million["thresh"]) == j["thresh"]
    np.testing.assert_array_equal(x.perm.numpy(), j["dest"])
    assert np.unique(j["dest"]).size == N_MILLION       # one slot each
    np.testing.assert_array_equal(x.reach.numpy(), j["reach"])
    np.testing.assert_array_equal(x.wst.numpy(), j["wst"])
    np.testing.assert_array_equal(x.wln.numpy(), j["wln"])
    np.testing.assert_array_equal(x.overflow.numpy(), j["overflow"])


def test_million_work_items_stay_in_their_rows(million):
    """Every tile of ``window_items`` at a million aircraft lies in the
    grid, every non-empty item inside its row's tiles, and the items of a
    row cover its segment blocks once, in order."""
    x = million["x"]
    items = cd_sched.window_items(x.wst, x.wln, x.wmax, x.nb)
    tiles = items.tiles.numpy().astype(np.int64)
    start = items.start.numpy().astype(np.int64)
    length = items.length.numpy().astype(np.int64)
    nb, w = tiles.shape
    assert nb == x.nb and w == x.wst.shape[1] * x.wmax
    ln = np.minimum(x.wln.numpy(), x.wmax)
    count = ln.sum(1)                    # no segment runs past the grid
    assert (start >= 0).all() and (length >= 0).all()
    # an empty item (length 0) reads nothing, wherever it starts
    assert ((length == 0) | (start + length <= count[:, None])).all()
    assert (length.sum(1) == count).all()
    valid = np.arange(w)[None, :] < count[:, None]
    assert (tiles[valid] < nb).all() and (tiles[valid] >= 0).all()
    st = x.wst.numpy()
    for i in np.flatnonzero(count)[::97]:
        want = np.concatenate([np.arange(b, b + k)
                               for b, k in zip(st[i], ln[i]) if k])
        np.testing.assert_array_equal(tiles[i, :count[i]], want)
    assert sorted(items.order.numpy().tolist()) == list(range(nb))


# ------------------------------------------------- JAX's row-split path

N_SPLIT = 192
BLOCK_SPLIT = 16
#: 12 row blocks of aircraft and 4 empty ones: nb = 16
EXTRA_SPLIT = 4
#: JAX's split constants, set on its module for these cases: one
#: variant past 4 row blocks, pieces of at most 5 rows (5, 5, 5, 1)
ONE_VARIANT, MAX_ROWS = 4, 5


def split_columns(geom, seed=0):
    """Small fleets dense enough to conflict: "global" is two clumps, one
    across the date line at 65 N and one at 40 S (both hemispheres and
    the longitude wrap in one fleet), "equator" straddles the equator."""
    rng = np.random.default_rng(seed)
    n = N_SPLIT
    if geom == "global":
        half = n // 2
        lat = np.concatenate([rng.uniform(64.0, 66.0, half),
                              rng.uniform(-41.0, -39.0, n - half)])
        lon = np.concatenate([rng.uniform(178.5, 181.5, half),
                              rng.uniform(19.0, 21.0, n - half)])
        lon = np.where(lon >= 180.0, lon - 360.0, lon)
    else:
        lat = rng.uniform(-1.5, 1.5, n)
        lon = rng.uniform(-2.0, 2.0, n)
    gs = rng.uniform(130.0, 240.0, n)
    trk = rng.uniform(0.0, 360.0, n)
    alt = rng.uniform(9000.0, 11000.0, n)
    vs = rng.uniform(-8.0, 8.0, n)
    return dict(lat=lat, lon=lon, trk=trk, gs=gs, alt=alt, vs=vs,
                active=rng.random(n) > 0.05, noreso=rng.random(n) > 0.9)


def moved(c, t):
    trk = np.radians(c["trk"])
    d = dict(c)
    d["lat"] = c["lat"] + c["gs"] * np.cos(trk) * t / 111320.0
    lon = c["lon"] + c["gs"] * np.sin(trk) * t / (
        111320.0 * np.cos(np.radians(d["lat"])))
    d["lon"] = (lon + 180.0) % 360.0 - 180.0
    return d


def ordered(c):
    trk = np.radians(c["trk"])
    f = lambda a: np.asarray(a, np.float32)
    return [f(c["lat"]), f(c["lon"]), f(c["trk"]), f(c["gs"]), f(c["alt"]),
            f(c["vs"]), f(c["gs"] * np.sin(trk)), f(c["gs"] * np.cos(trk)),
            np.asarray(c["active"]), np.asarray(c["noreso"])]


def _mvp(mod):
    return mod.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                         tlookahead=TLOOK)


@pytest.fixture(scope="class")
def jax_split():
    """JAX's sparse CD&R in interpret mode with its row split forced:
    the module constants set for the fixture's life (and JAX's caches
    cleared on both sides, so no trace of either setting is reused), and
    ``pl.pallas_call`` wrapped to record the grid of every
    ``_sched_kernel`` call, for the cases of ``TestRowSplit`` only.
    Returns ``(run, grids)``."""
    mp = pytest.MonkeyPatch()
    grids = []
    orig = jsched.pl.pallas_call

    def counting(kernel, *a, **kw):
        if getattr(kernel, "func", None) is jsched._sched_kernel:
            grids.append(tuple(kw["grid_spec"].grid))
        return orig(kernel, *a, **kw)
    jax.clear_caches()
    mp.setattr(jsched, "_ONE_VARIANT_ROWS", ONE_VARIANT)
    mp.setattr(jsched, "_MAX_ROWS", MAX_ROWS)
    mp.setattr(jsched.pl, "pallas_call", counting)

    @jax.jit
    def run(cols, perm, partners):
        return jsched.detect_resolve_sched(
            *cols, RPZ, HPZ, TLOOK, _mvp(jmvp), block=BLOCK_SPLIT,
            extra_blocks=EXTRA_SPLIT, interpret=True, perm=perm,
            partners=partners, resume_rpz_m=RPZ * 1.05)
    yield run, grids
    mp.undo()
    jax.clear_caches()


def _split_case(jax_split, c, table):
    run, grids = jax_split
    cols = ordered(c)
    ct = [torch.from_numpy(a) for a in cols]
    thresh = cd_sched.reach_threshold_m(ct[3], ct[8], TLOOK, RPZ)
    perm = cd_sched.stripe_sort_dest(ct[0], ct[1], ct[3], ct[8], thresh,
                                     BLOCK_SPLIT, EXTRA_SPLIT).numpy()
    j = jax.tree_util.tree_map(np.asarray, run(
        [jnp.asarray(a) for a in cols], jnp.asarray(perm),
        jnp.asarray(table)))
    rd, pnew, act = cd_sched.detect_resolve_sched(
        *ct, RPZ, HPZ, TLOOK, _mvp(cr_mvp),
        partners=torch.from_numpy(np.array(table)), resume_rpz_m=RPZ * 1.05,
        block=BLOCK_SPLIT, extra_blocks=EXTRA_SPLIT,
        perm=torch.from_numpy(perm))
    t = ([np.asarray(v) for v in rd], pnew.numpy(), act.numpy())
    return cols, j, t


def _sums64(cols):
    """The float64 witness of the three MVP sums: every ownship against
    every aircraft (``cd_pallas.row_block_plain`` on float64 slabs of the
    float32 inputs; the sums need no partner table)."""
    sl = slab64(cols, "tas", cols[3])           # the tr row: unread by MVP
    ids = torch.arange(sl.shape[1])
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(cr_mvp))
    out = cd_pallas.row_block_plain(sl, sl, ids, ids, None, p)
    return dict(sum_dve=out[2].numpy(), sum_dvn=out[3].numpy(),
                sum_dvv=out[4].numpy())


#: rows a case may hold to the float64 witness instead of JAX's sums
SPLIT_WITNESS_ROWS = 2


def _assert_split_match(cols, j, t):
    """Flags, counts, engagement and the partner and top-K sets equal;
    tcpamax and tsolv within rtol 1e-4 / atol 5e-3 of JAX's; the three
    sums too, but for at most ``SPLIT_WITNESS_ROWS`` rows where float32
    order parts the packages (an ill-conditioned pair, ROADMAP §C): there
    the port's sum is no further from the float64 witness than JAX's,
    plus the atol."""
    (jrd, jp, ja), (trd, tp, ta) = j, t
    jd, td = dict(zip(jrd._fields, jrd)), dict(zip(jrd._fields, trd))
    for k in ("inconf", "nconf", "nlos"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for k in ("tcpamax", "tsolv"):
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=5e-3,
                                   err_msg=k)
    w64 = None
    for k in ("sum_dve", "sum_dvn", "sum_dvv"):
        off = np.abs(td[k] - jd[k]) > 5e-3 + 1e-4 * np.abs(jd[k])
        if not off.any():
            continue
        assert off.sum() <= SPLIT_WITNESS_ROWS, (k, np.flatnonzero(off))
        w64 = _sums64(cols) if w64 is None else w64
        w = w64[k][off]
        assert (np.abs(td[k][off] - w)
                <= np.abs(jd[k][off] - w) + 5e-3).all(), \
            (k, np.flatnonzero(off), td[k][off], jd[k][off], w)
    assert partner_sets(td["topk_idx"]) == partner_sets(jd["topk_idx"])
    assert partner_sets(tp) == partner_sets(jp)
    np.testing.assert_array_equal(ta, ja)


class TestRowSplit:
    """The cases that run JAX's forced row split (``jax_split``)."""

    @pytest.mark.parametrize("geom", ["global", "equator"])
    def test_jax_row_split_matches_the_port(self, jax_split, geom):
        """JAX's row-split grid (pieces of 5, 5, 5 and 1 row blocks, one
        kernel variant) and the port's single launch give the same
        interval, from an empty partner table and resumed from JAX's
        merged table with the fleet moved 20 s on."""
        n_tot = (-(-N_SPLIT // BLOCK_SPLIT) + EXTRA_SPLIT) * BLOCK_SPLIT
        assert n_tot // BLOCK_SPLIT == 16
        c = split_columns(geom)
        table = np.full((n_tot, 8), -1, np.int32)
        before = len(jax_split[1])
        cols, j, t = _split_case(jax_split, c, table)
        assert int(j[0].nconf) > 0
        _assert_split_match(cols, j, t)
        assert int(j[2].sum()) > 0              # engaged partners to keep
        cols, j2, t2 = _split_case(jax_split, moved(c, 20.0), j[1])
        _assert_split_match(cols, j2, t2)
        # the split ran: the first call traced the 4 pieces (the cases
        # share one compiled function)
        grids = jax_split[1]
        assert grids[:4] == [(5,), (5,), (5,), (1,)]
        assert len(grids) - before in (0, 4) and len(grids) % 4 == 0


# --------------------------------------------- bench's fleets run whole

N_RUN = 256
BLOCK_RUN = 64
CHUNKS, CHUNK = 3, 20


def _bench_pair(geometry):
    """bench's fleet of ``N_RUN`` aircraft in as many slots: JAX's own
    ``bench._make_traffic`` and the port's ``Traffic`` from
    ``bench_draws`` (no pair matrix, float32)."""
    jt = bench._make_traffic(N_RUN, geometry, False, jnp.float32)
    tt = TTraffic(nmax=N_RUN, pair_matrix=False, device="cpu")
    lat, lon, alt, spd, hdg = bench_draws(N_RUN, geometry)
    tt.create(N_RUN, "B744", alt, spd, None, lat, lon, hdg)
    tt.flush()
    return jt.state, tt.state


def _chunks(pkg, state, backend):
    asas_m, step_m = (jasas, jstep) if pkg == "jax" else (tasas, tstep)
    cfg = step_m.SimConfig(cd_backend=backend, cd_block=BLOCK_RUN)
    for _ in range(CHUNKS):
        state = asas_m.refresh_spatial_sort(
            state, cfg.asas, block=BLOCK_RUN,
            impl=asas_m.impl_for_backend(backend))
        state = step_m.run_steps(state, cfg, CHUNK)
    return state


RUN_CASES = [(g, b) for g in ("global", "regional")
             for b in ("sparse", "pallas")]


@pytest.fixture(scope="module")
def bench_runs():
    """JAX's and the port's three chunks of every case, the initial
    states beside them (one module-scoped JAX reference: JAX compiles
    each backend's chunk once for both fleets)."""
    out = {}
    for geom, backend in RUN_CASES:
        js, ts = _bench_pair(geom)
        j0, t0 = jax_tree_to_numpy(js), state_to_numpy(ts)
        out[geom, backend] = dict(
            j0=j0, t0={k: np.array(v) for k, v in t0.items()},
            j=jax_tree_to_numpy(_chunks("jax", js, backend)),
            t=state_to_numpy(_chunks("torch", ts, backend)))
    return out


#: each backend's pair state (``tests/test_torch_slice.py``)
TABLE = {"sparse": "asas.partners_s", "pallas": "asas.partners"}


@pytest.mark.parametrize("geom,backend", RUN_CASES)
def test_bench_fleet_runs_as_jax(bench_runs, geom, backend):
    """bench's fleet, created alike in both packages, stays with JAX's
    through 3 simulated seconds: counts, flags, the sort and the partner
    sets equal, positions within 1e-5 deg, altitude 1e-2 m, the rest
    rtol 1e-4 / atol 1e-3."""
    r = bench_runs[geom, backend]
    for k in r["j0"]:
        if k != "rng":
            np.testing.assert_array_equal(r["j0"][k], r["t0"][k], err_msg=k)
    j, t = r["j"], r["t"]
    if geom == "regional":
        assert int(j["asas.nconf_cur"]) > 0
    for k in ("asas.nconf_cur", "asas.nlos_cur", "asas.inconf",
              "asas.active", "ac.active", "asas.sort_perm", "perf.phase"):
        np.testing.assert_array_equal(j[k], t[k], err_msg=k)
    assert partner_sets(j[TABLE[backend]]) == partner_sets(t[TABLE[backend]])
    assert float(j["simt"]) == float(t["simt"])
    for k in ("ac.lat", "ac.lon"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(t["ac.alt"], j["ac.alt"], rtol=0, atol=1e-2)
    for k in ("ac.tas", "ac.gs", "ac.vs", "ac.trk", "ac.hdg", "asas.trk",
              "asas.tas", "asas.vs", "asas.tcpamax"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-3,
                                   err_msg=k)


def test_global_fleet_spans_the_date_line_and_both_hemispheres(bench_runs):
    """bench's global draw puts aircraft on both sides of the equator and
    of the date line (what JAX's one-variant path exists for)."""
    lat, lon = bench_runs["global", "sparse"]["t0"]["ac.lat"], \
        bench_runs["global", "sparse"]["t0"]["ac.lon"]
    assert (lat < 0).any() and (lat > 0).any()
    assert (lon < -170).any() and (lon > 170).any()
    assert np.abs(lat).max() < 70.0


# ------------------------------------------- the flush of several types

@functools.lru_cache(maxsize=None)
def _mixed_pair():
    types = ["B744", "A320", "B738", "A320", "E190", "B744", "ZZZZ", "A320"]
    n = len(types) * 12
    rng = np.random.default_rng(5)
    kw = dict(acalt=rng.uniform(3000.0, 11000.0, n),
              acspd=rng.uniform(130.0, 240.0, n), dest=None,
              aclat=rng.uniform(50.0, 54.0, n),
              aclon=rng.uniform(2.0, 8.0, n),
              achdg=rng.uniform(0.0, 360.0, n))
    acid = [f"MX{i:04d}" for i in range(n)]
    jt = JTraffic(nmax=128, dtype=jnp.float32, pair_matrix=False)
    tt = TTraffic(nmax=128, pair_matrix=False, device="cpu")
    for t in (jt, tt):
        t.create(n, (types * 12)[:n], acid=acid, **kw)
        t.flush()
    return jax_tree_to_numpy(jt.state), state_to_numpy(tt.state), tt


def test_flush_of_several_types_matches_jax():
    """One flush of eight types (one unknown) fills every performance
    column as JAX's per-aircraft flush does, and the host bookkeeping
    names each slot's callsign and type."""
    j, t, tt = _mixed_pair()
    perf = [k for k in j if k.startswith("perf.")]
    assert len(perf) > 20
    for k in perf:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(j[k], t[k], err_msg=k)
    assert tt.ids[:3] == ["MX0000", "MX0001", "MX0002"]
    assert tt.types[6] == "ZZZZ" and tt.id2idx("MX0006") == 6
