"""Partner tables wider than the block and wider than 32
(``Traffic(k_partners=K)``, ROADMAP B2 and C6) on the port's blockwise
backends against the JAX package, on the CPU: the plain versions of the
kernels in the port, JAX's sparse and pallas kernels in interpret mode,
its tiled backend as plain XLA.

* C6: the clump of ``test_torch_kpartners`` (200 aircraft within 0.6 deg
  at one altitude in 256 slots) on the pallas backend at block 16 and
  K = 24, one sort refresh and one MVP interval against JAX's pallas.
  The port once cut the table at the block (``min(K, block)``, which
  only JAX's tiled backend does); JAX fills all 24 columns, and 86 rows
  hold more than 16 partners.
* K = 40 (two keep words an ownship) on the clump drawn in to 0.6 of its
  radius about its centre (~0.36 deg), block 64: the sparse backend
  against JAX's sparse and the pallas backend against JAX's pallas, one
  refresh and one MVP interval each, one module-scoped JAX reference per
  backend.  The densest rows conflict with up to 56 others, so the
  table is truncated there and the top-K order past 32 decides it; at
  least 40 rows hold more than 32 partners.  JAX's interpret mode unrolls
  its top-K loops K times, which is why these run at K = 40 and not 64.
* K = 64 and 128 on the drawn-in clump: the tiled backend against JAX's
  tiled (its block must be at least K, so block 64 and 128) under MVP
  and SSD (SSD resolves from the [N, K] table in both packages).
* Two stacked sparse worlds at K = 64 step bit for bit as their solo
  runs, each shard mode (REPLICATE, SPATIAL, TILE and the pallas
  replicate split, 4 CPU shards) at K = 64 steps bit for bit as its
  single-device reference, and a K = 64 state survives a snapshot save
  and load.

Held as ``test_torch_kpartners`` holds K = 16: the sort, the partner
sets, nconf, nlos and the conflict and ASAS flags equal; the pair sums
and the ASAS commands within rtol 2e-4 / atol 2e-3, a sum that misses it
held to the float64 witness (the ownship's sums recomputed in float64
from the same float32 inputs) within the same tolerance, at most
``WITNESSED`` rows per interval, whose commands are then left out.  In
the drawn-in clump a row sums up to ~60 MVP displacements that cancel:
on row 149 of the K = 64 tiled interval the terms' magnitudes add to
3,198 for a sum of 23.19 (4,127 for 1.49), and both packages' float32
sums lie 1e-4 to 4e-3 (relative) off the float64 witness.  A resolver
sum is therefore also held to the witness within ``SUM_EPS`` of the
float64 sum of its terms' magnitudes (``_abs_witness``): a float32 sum
of m terms rounds by at most about m * 2**-24 of that, 4e-6 at m = 64.
"""
import time

import jax
import numpy as np
import pytest
import torch

from bluesky_tpu.core import asas as jasas
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu_torch.core import asas as tasas, graph, step as tstep
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
from bluesky_tpu_torch.ops import cd_pallas
from bluesky_tpu_torch.parallel import sharding
from bluesky_tpu_torch.simulation import snapshot
from bluesky_tpu_torch.simulation.sim import Simulation

from torch_parity import (jax_tree_to_numpy, partner_sets, scene, slab64,
                          sim_do)

NMAX, N = 256, 200
RTOL, ATOL = 2e-4, 2e-3
#: rows of one interval whose sums may need the float64 witness
WITNESSED = 3
#: a resolver sum's bound against the witness, relative to the float64
#: sum of its terms' magnitudes (float32 rounding of up to 64 terms)
SUM_EPS = 1e-5
#: JAX interpret-mode seconds of each reference, printed by the fixtures
TIMES = {}


def _clump(seed=3, shrink=1.0):
    """The K = 16 tests' clump at 9,500 m, drawn in about its centre by
    ``shrink``."""
    lat, lon, hdg, alt, spd = scene(N, "clump", seed)
    lat = 52.6 + (lat - 52.6) * shrink
    lon = 5.4 + (lon - 5.4) * shrink
    return lat, lon, hdg, np.full_like(alt, 9500.0), spd


def _traffic(cls, kk, shrink=1.0, seed=3, lat_shift=0.0, **kw):
    lat, lon, hdg, alt, spd = _clump(seed, shrink)
    t = cls(nmax=NMAX, pair_matrix=False, k_partners=kk, **kw)
    t.create(N, "B744", alt, spd, None, lat + lat_shift, lon, hdg)
    t.flush()
    return t


def _witness(state, cfg):
    """The float64 witness of an interval's pair sums: every ownship of
    ``state`` against every aircraft in the MVP form of the tile body."""
    ac = state.ac
    cols = [a.numpy() for a in (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                                ac.gseast, ac.gsnorth, ac.active,
                                state.asas.noreso)]
    s64 = slab64(cols, "tas", ac.tas.numpy())
    gid = torch.arange(NMAX)
    p = cd_pallas.tile_params(cfg.rpz, cfg.hpz, cfg.dtlookahead,
                              tasas._mvp_config(cfg))
    return [a.numpy() for a in cd_pallas.row_block_plain(
        s64, s64, gid, gid, None, p)]


def _abs_witness(state, cfg):
    """The float64 sums of the magnitudes of each ownship's MVP pair terms
    (dve, dvn, dvv; outputs 2-4 as ``_witness`` orders them): the tile
    body on one intruder at a time gives each pair's terms."""
    ac = state.ac
    cols = [a.numpy() for a in (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                                ac.gseast, ac.gsnorth, ac.active,
                                state.asas.noreso)]
    s64 = slab64(cols, "tas", ac.tas.numpy())
    gid = torch.arange(NMAX)
    p = cd_pallas.tile_params(cfg.rpz, cfg.hpz, cfg.dtlookahead,
                              tasas._mvp_config(cfg))
    tot = torch.zeros((5, NMAX), dtype=torch.float64)
    for j in range(NMAX):
        o = cd_pallas.row_block_plain(s64, s64[:, j:j + 1], gid,
                                      gid[j:j + 1], None, p, kk=1)
        for i in (2, 3, 4):
            tot[i] += o[i].abs()
    return tot.numpy()


def _interval(impl, kk, block, shrink, reso="MVP"):
    """One refresh and one interval in both packages: ``((jax state, jax
    rd), (port state, port rd, float64 witness), port state)``, on numpy
    but the last; the JAX seconds go to ``TIMES``."""
    jcfg = jasas.AsasConfig(reso_method=reso)
    tcfg = tasas.AsasConfig(reso_method=reso)
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        js = jasas.refresh_spatial_sort(
            _traffic(JTraffic, kk, shrink).state, jcfg, block=block,
            impl=impl)
        js, jrd = jasas.update_tiled(js, jcfg, block=block, impl=impl)
        jax.block_until_ready(js)
    TIMES[(impl, kk, block, reso)] = time.perf_counter() - t0
    print(f"JAX {impl} K={kk} block {block} {reso}: "
          f"{TIMES[(impl, kk, block, reso)]:.1f} s")
    ts0 = tasas.refresh_spatial_sort(
        _traffic(TTraffic, kk, shrink, device="cpu").state, tcfg,
        block=block, impl=impl)
    ts, trd = tasas.update_tiled(ts0, tcfg, block=block, impl=impl)
    return (jax_tree_to_numpy(js), jax.tree_util.tree_map(np.asarray, jrd)), \
        (state_to_numpy(ts), [np.asarray(a) for a in trd],
         _witness(ts0, tcfg), _abs_witness(ts0, tcfg)), ts


def _wide(table, more):
    """Rows of a partner table with more than ``more`` partners."""
    return int(((table >= 0).sum(1) > more).sum())


def _assert_interval(j, t, table, kk):
    (js, jrd), (ts, trd, wit, absw) = j, t
    assert ts[table].shape[1] == kk
    assert partner_sets(ts[table]) == partner_sets(js[table])
    for k in ("asas.sort_perm", "asas.nconf_cur", "asas.nlos_cur",
              "asas.inconf", "asas.active"):
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    jd, td = dict(zip(jrd._fields, jrd)), dict(zip(jrd._fields, trd))
    close = lambda a, b: np.isclose(a, b, rtol=RTOL, atol=ATOL)
    witnessed = np.zeros(NMAX, bool)
    for k, i in (("tcpamax", 1), ("sum_dve", 2), ("sum_dvn", 3),
                 ("sum_dvv", 4), ("tsolv", 5)):
        got, want, w = td[k], jd[k], wit[i]
        ok = close(got, want)
        held = close(got, w)
        if i in (2, 3, 4):
            held |= np.abs(got - w) <= SUM_EPS * absw[i] + ATOL
        assert (ok | held).all(), (k, np.flatnonzero(~(ok | held)))
        witnessed |= ~ok
    print(f"{table}: rows held to the witness {np.flatnonzero(witnessed)}")
    assert int(witnessed.sum()) <= WITNESSED, np.flatnonzero(witnessed)
    for k in ("asas.trk", "asas.tas", "asas.vs", "asas.alt"):
        np.testing.assert_allclose(ts[k][~witnessed], js[k][~witnessed],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def pallas_c6():
    return _interval("pallas", 24, 16, 1.0)


@pytest.fixture(scope="module")
def sparse40():
    return _interval("sparse", 40, 64, 0.6)


@pytest.fixture(scope="module")
def pallas40():
    return _interval("pallas", 40, 64, 0.6)


def test_pallas_keeps_k_past_the_block(pallas_c6):
    """C6: on the pallas backend at K = 24 > block = 16 the caller-space
    table holds JAX's 24-wide sets; more than 80 rows hold more than 16
    partners (the cut table held at most 16)."""
    j, t, _ = pallas_c6
    assert _wide(t[0]["asas.partners"], 16) >= 80
    assert _wide(j[0]["asas.partners"], 16) >= 80
    _assert_interval(j, t, "asas.partners", 24)


def test_sparse_k40_matches_jax(sparse40):
    """The sparse backend at K = 40 (two keep words): the in-kernel merged
    sorted-space table ``partners_s`` holds JAX's sets."""
    j, t, _ = sparse40
    assert _wide(t[0]["asas.partners_s"], 32) >= 40
    _assert_interval(j, t, "asas.partners_s", 40)


def test_pallas_k40_matches_jax(pallas40):
    """The pallas backend at K = 40: the caller-space table ``partners``
    holds JAX's sets."""
    j, t, _ = pallas40
    assert _wide(t[0]["asas.partners"], 32) >= 40
    _assert_interval(j, t, "asas.partners", 40)


@pytest.mark.parametrize("kk", [64, 128])
@pytest.mark.parametrize("reso", ["MVP", "SSD"])
def test_tiled_wide_matches_jax(kk, reso):
    """The tiled backend at K = 64 (block 64) and 128 (block 128) under
    MVP and SSD: the caller-space table holds JAX's sets, rows with more
    than 32 partners among them; SSD resolves from it in both
    packages."""
    j, t, _ = _interval("lax", kk, kk, 0.6, reso)
    assert _wide(t[0]["asas.partners"], 32) >= 40
    _assert_interval(j, t, "asas.partners", kk)


def _copy(st):
    return graph.rebuild(st, iter([x.clone() for _, x in graph.leaves(st)]))


def test_k64_worlds_bit_equal_solo():
    """Two stacked sparse worlds at K = 64 (the drawn-in clump, and
    another from another seed 1 deg north), 21 steps (two ASAS
    intervals), equal their solo runs bit for bit."""
    cfg = tstep.SimConfig(cd_backend="sparse", cd_block=64)
    states = [tasas.refresh_spatial_sort(
        _traffic(TTraffic, 64, 0.6, seed=s, lat_shift=d, device="cpu").state,
        cfg.asas, block=64, impl="sparse") for s, d in ((3, 0.0), (4, 1.0))]
    solo = [tstep.run_steps(_copy(s), cfg, 21) for s in states]
    got = tstep.unstack_worlds(tstep.run_steps_worlds(
        tstep.stack_worlds(states), cfg, 21))
    for ref, g in zip(solo, got):
        a, b = state_to_numpy(ref), state_to_numpy(g)
        assert a["asas.partners_s"].shape[1] == 64
        assert _wide(a["asas.partners_s"], 32) >= 20
        bad = [k for k in a if not np.array_equal(a[k], b[k],
                                                  equal_nan=True)]
        assert not bad, bad


@pytest.mark.parametrize("mode", ["replicate", "spatial", "tiles",
                                  "pallas"])
def test_k64_shard_modes_bit_equal_reference(mode):
    """25 steps of the drawn-in clump at K = 64 (200 aircraft in 1,024
    slots, block 64: a spatial shard holds nmax / 4 and the clump lies
    in one stripe) on 4 CPU shards in each mode, and on the mode's
    single-device reference (the same prepared state and config without
    the mesh): every state tensor bit-equal, with rows of more than 32
    partners."""
    lat, lon, hdg, alt, spd = _clump(3, 0.6)
    t = TTraffic(nmax=1024, pair_matrix=False, k_partners=64, device="cpu")
    t.create(N, "B744", alt, spd, None, lat, lon, hdg)
    t.flush()
    st, devs = t.state, [torch.device("cpu")] * 4
    cfg = tstep.SimConfig(cd_backend="pallas" if mode == "pallas"
                          else "sparse", cd_block=64)
    if mode == "spatial":
        mesh = sharding.make_mesh(4, devices=devs)
        st, _, info = sharding.prepare_spatial(st, mesh, cfg.asas, block=64)
        cfg = cfg._replace(cd_shard_mode="spatial",
                           cd_halo_blocks=info["halo_blocks"])
    elif mode == "tiles":
        mesh = sharding.make_tile_mesh((2, 2), devices=devs)
        st, _, info = sharding.prepare_tiles(st, mesh, cfg.asas, block=64)
        cfg = cfg._replace(cd_shard_mode="tiles",
                           cd_tile_shape=tuple(info["tile_shape"]),
                           cd_tile_budgets=tuple(info["budgets"]))
    else:
        mesh = sharding.make_mesh(4, devices=devs)
    ref = tstep.run_steps(_copy(st), cfg, 25)
    out = sharding.sharded_step_fn(mesh, cfg, nsteps=25)(_copy(st))
    a, b = state_to_numpy(ref), state_to_numpy(out)
    table = a["asas.partners" if mode == "pallas" else "asas.partners_s"]
    assert table.shape[1] == 64 and _wide(table, 32) >= 20
    bad = [k for k in a if not np.array_equal(a[k], b[k], equal_nan=True)]
    assert not bad, bad


def _k64_sim():
    s = Simulation(nmax=NMAX, device="cpu")
    s.traf.pair_matrix = False
    s.traf.k_partners = 64
    s.reset()
    return s


def _go(sim, until):
    sim.op()
    sim.fastforward()
    sim.run(until_simt=until)


def _same_state(a, b):
    sa, sb = state_to_numpy(a.traf.state), state_to_numpy(b.traf.state)
    assert sorted(sa) == sorted(sb)
    bad = [k for k in sa if not (sa[k].dtype == sb[k].dtype and
                                 np.array_equal(sa[k], sb[k],
                                                equal_nan=True))]
    assert not bad, bad
    assert a.traf.ids == b.traf.ids and a.simt == b.simt


def test_k64_state_round_trip(tmp_path):
    """A K = 64 state with more than 32 partners in some rows, saved and
    loaded into another such sim, is bit for bit the same, and both runs
    stay equal one more second."""
    sim = _k64_sim()
    lat, lon, hdg, alt, spd = _clump(3, 0.6)
    sim.traf.create(N, "B744", alt, spd, None, lat, lon, hdg)
    sim.traf.flush()
    sim_do(sim, "CDMETHOD SPARSE", "ASAS ON")
    _go(sim, 1.5)
    table = state_to_numpy(sim.traf.state)["asas.partners_s"]
    assert table.shape[1] == 64 and _wide(table, 32) >= 20
    fname = str(tmp_path / "k64.snap")
    snapshot.save(sim, fname)
    other = _k64_sim()
    ok, msg = snapshot.load(other, fname)
    assert ok, msg
    _same_state(sim, other)
    _go(sim, 2.5)
    _go(other, 2.5)
    _same_state(sim, other)


def test_partials_that_do_not_fit_name_bytes():
    """Buffers the device cannot allocate raise ``ValueError`` naming
    the bytes they take (the shared-memory refusal is held by
    ``test_torch_cd_pallas.test_k16_partners_match_jax``)."""
    def oom():
        raise torch.cuda.OutOfMemoryError("no room")
    with pytest.raises(ValueError, match="123456 bytes"):
        cd_pallas.alloc_or_raise("the partials", 123456, oom)
