"""The port's chunk runners (``core/step.py``) and captured chunks
(``core/graph.py``), on the CPU.

* Against JAX, on the same numpy-seeded dense scene (24 aircraft in a
  0.3 x 0.4 deg box, 32 slots, float32, 20 steps): ``run_steps_checked``
  returns JAX's first bad step (-1 clean, 0 with a NaN in a live row,
  -1 with a NaN in a padding row only), and ``pack_telemetry`` equals
  JAX's ``EdgeTelemetry`` field by field: ints, bools and ``simt``
  equal, floats within the tolerances of ``tests/test_torch_slice.py``
  (lat/lon 1e-5 deg, altitude 1e-2 m, the rest rtol 1e-4 / atol 1e-3:
  the two float32 pipelines differ only in rounding), in buffers of
  its own.
* The in-scan sort refresh on the sparse plain path, as
  ``tests/test_inscan_refresh.py`` holds JAX's: a dyadic ``simdt`` of
  0.0625 s with ``sort_every=2`` and ``dtasas=1`` puts the refresh
  every 32 steps exactly, so a 96-step in-scan chunk equals three
  rounds of host refresh plus 32 steps, bit for bit.
* The flags: off, a chunk equals ``run_steps``; on, the stepped state
  does not change.
* The graph executor with a stand-in capture that runs the body (its
  warm-up step) instead of recording it, since a CUDA graph needs the
  card: bit-equal to the eager chunk for every runner and flag, no host
  read in the body it would capture, the donation contract, and the
  host gate schedule of ``step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from bluesky_tpu.core import step as jstep
from bluesky_tpu_torch.core import asas as tasas, graph, step as tstep
from bluesky_tpu_torch.core.state import state_to_numpy

from torch_parity import build_pair

NSTEPS = 20


def _jcopy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


def _tcopy(state):
    return graph.rebuild(state, iter([t.clone()
                                      for _, t in graph.leaves(state)]))


def _with_nan(state, row):
    """A copy of the port's ``state`` with a NaN latitude in ``row``."""
    s = _tcopy(state)
    s.ac.lat[row] = float("nan")
    return s


def _numpy(state):
    """Copies of a state's arrays (on the CPU ``state_to_numpy`` shares
    the tensors' memory, which a donated chunk writes)."""
    return {k: np.array(v, copy=True)
            for k, v in state_to_numpy(state).items()}


def _assert_equal(a, b):
    a, b = _numpy(a), _numpy(b)
    bad = [k for k in a if not np.array_equal(a[k], b[k], equal_nan=True)]
    assert not bad, bad


@pytest.fixture(scope="module")
def dense():
    """The dense cluster scene in both packages, and JAX's checked edge
    chunk of it."""
    jstate, tstate = build_pair(32, 24, geom="cluster", pair_matrix=True)
    jout = jstep.run_steps_edge(_jcopy(jstate), jstep.SimConfig(), NSTEPS,
                                checked=True)
    return jstate, tstate, jout


@pytest.mark.parametrize("nan_row", [None, 0, 30],
                         ids=["clean", "live-row", "padding-row"])
def test_checked_runner_matches_jax(dense, nan_row):
    jstate, tstate, _ = dense
    if nan_row is not None:
        jstate = jstate.replace(ac=jstate.ac.replace(
            lat=jstate.ac.lat.at[nan_row].set(jnp.nan)))
        tstate = _with_nan(tstate, nan_row)
    _, jbad = jstep.run_steps_checked(_jcopy(jstate), jstep.SimConfig(),
                                      NSTEPS)
    out, bad = tstep.run_steps_checked(tstate, tstep.SimConfig(), NSTEPS)
    assert bad.dtype == torch.int32 and bad.shape == ()
    assert int(bad) == int(jbad) == {None: -1, 0: 0, 30: -1}[nan_row]
    assert int(out.asas.nconf_cur) > 0


def test_telemetry_matches_jax(dense):
    _, tstate, (_, jtel) = dense
    out, tel = tstep.run_steps_edge(tstate, tstep.SimConfig(), NSTEPS,
                                    checked=True)
    assert tel._fields == jtel._fields
    assert int(tel.nconf_cur) > 0
    for f in tel._fields:
        t, j = getattr(tel, f).numpy(), np.asarray(getattr(jtel, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f
        if f in ("lat", "lon"):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5, err_msg=f)
        elif f == "alt":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-2, err_msg=f)
        elif t.dtype.kind == "f" and f != "simt":
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-3,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)
    assert float(tel.simt) == float(out.simt)
    # every field is a buffer of its own
    owned = {t.untyped_storage().data_ptr() for _, t in graph.leaves(out)}
    assert not owned & {t.untyped_storage().data_ptr() for t in tel}


# ------------------------------------------------------------ in-scan refresh

ACFG = tasas.AsasConfig(sort_every=2, dtasas=1.0)
SIMDT = 0.0625
PERIOD_STEPS = 32            # 2.0 s / 0.0625 s, exact in float32


@pytest.fixture(scope="module")
def sparse_scene():
    return build_pair(64, 48, pair_matrix=False)[1]


def _sparse_cfg(**kw):
    return tstep.SimConfig(simdt=SIMDT, asas=ACFG, cd_backend="sparse",
                           cd_block=32, **kw)


def test_inscan_refresh_equals_host_rounds(sparse_scene):
    cfg = _sparse_cfg(inscan_refresh=True)
    assert tstep.inscan_refresh_active(cfg)
    st, _, rpack = tstep.run_steps_edge_keep(sparse_scene, cfg, 96)
    assert int(rpack.count) == 3
    assert float(rpack.sort_t) == 4.0
    assert rpack.sort_t.dtype == np.float32
    assert int(rpack.guard) == 0
    assert rpack.newslot.shape == (0,)

    s = sparse_scene
    cfg_off = cfg._replace(inscan_refresh=False)
    for _ in range(3):
        s = tasas.refresh_spatial_sort(s, ACFG, block=32, impl="sparse")
        s = tstep.run_steps(s, cfg_off, PERIOD_STEPS)
    _assert_equal(st, s)


def test_inscan_sort_t_chains_across_chunks(sparse_scene):
    cfg = _sparse_cfg(inscan_refresh=True)
    st1, _, p1 = tstep.run_steps_edge_keep(sparse_scene, cfg, 48)
    st2, _, p2 = tstep.run_steps_edge_keep(st1, cfg, 48, sort_t0=p1.sort_t)
    assert int(p1.count) + int(p2.count) == 3
    ref = tstep.run_steps_edge_keep(sparse_scene, cfg, 96)[0]
    _assert_equal(st2, ref)


def test_inscan_flag_inert_outside_sparse():
    tstate = build_pair(8, 4)[1]
    for backend in ("tiled", "pallas", "dense"):
        cfg = tstep.SimConfig(simdt=SIMDT, asas=ACFG, cd_backend=backend,
                              cd_block=32, inscan_refresh=True)
        assert not tstep.inscan_refresh_active(cfg)
    out = tstep.run_steps_edge(tstate, cfg._replace(cd_backend="tiled"), 2)
    assert len(out) == 2


def test_flags_off_is_run_steps_and_on_leaves_the_state(sparse_scene):
    cfg = _sparse_cfg()
    ref = tstep.run_steps(sparse_scene, cfg, NSTEPS)
    off = tstep.run_steps_edge(sparse_scene, cfg, NSTEPS)
    assert len(off) == 2
    _assert_equal(off[0], ref)
    on = tstep.run_steps_edge(sparse_scene, cfg._replace(
        scanstats=True, fingerprint=True), NSTEPS, checked=True)
    assert [type(x).__name__ for x in on[2:]] == ["ScanStats",
                                                   "FingerprintPack"]
    _assert_equal(on[0], ref)


# ----------------------------------------------------- the graph executor

#: operations that read the device back to the host, or copy from it
HOST_READS = {"__bool__", "item", "__int__", "__float__", "__index__",
              "tolist", "numpy", "cpu", "nonzero", "masked_select",
              "unique", "unique_consecutive", "bincount",
              "repeat_interleave", "tensor", "as_tensor", "from_numpy"}


class NoHostRead(TorchFunctionMode):
    """Raise on an operation that reads back to the host (on the card it
    would break the capture, or freeze a value into the graph), and on a
    boolean mask index (a data-dependent shape)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        bool_index = name in ("__getitem__", "__setitem__", "index_put",
                              "index_put_") and any(
            isinstance(a, torch.Tensor) and a.dtype == torch.bool
            for a in (args[1] if isinstance(args[1], (tuple, list))
                      else [args[1]]))
        if name in HOST_READS or bool_index:
            raise AssertionError(f"host read in a captured step: {name}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def stand_in(monkeypatch):
    """Chunks of CPU states through ``graph.ChunkGraphs``, with a capture
    that runs the body once under ``NoHostRead`` (the warm-up step) and
    replays by running it again."""
    captured = []

    def capture(body, device, gen):
        with NoHostRead():
            body()
        captured.append(body)
        return body

    graph.clear()
    monkeypatch.setattr(tstep, "_graphed", lambda state: True)
    monkeypatch.setattr(graph, "_capture", capture)
    yield captured
    graph.clear()


NOISE = dict(noise=tstep.NoiseConfig(turb_active=True, adsb_transnoise=True))
CASES = {
    "dense": ("dense", {}),
    "dense-flags": ("dense", dict(scanstats=True, fingerprint=True)),
    "dense-noise": ("dense", NOISE),
    "sparse-inscan": ("sparse", dict(inscan_refresh=True, scanstats=True,
                                     fingerprint=True)),
    "pallas-scanstats": ("pallas", dict(scanstats=True)),
    "tiled-fingerprint": ("tiled", dict(fingerprint=True)),
}


def _snap(out):
    """A chunk's outputs as numpy arrays: the state, then every tensor
    of the telemetry and packs, and ``RefreshPack.sort_t``."""
    arrs = [_numpy(out[0])]
    for x in out[1:]:
        arrs += [t.numpy().copy() for _, t in graph.leaves(x)]
        if isinstance(x, tstep.RefreshPack):
            arrs.append(np.asarray(x.sort_t))
    return arrs


def _sort_t(out):
    """The ``sort_t0`` of the chunk after ``out``."""
    packs = [x for x in out if isinstance(x, tstep.RefreshPack)]
    return packs[0].sort_t if packs else None


def _assert_snaps_equal(a, b):
    _assert_equal_np(a[0], b[0])
    assert len(a) == len(b)
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)


@pytest.mark.parametrize("case", CASES)
def test_graph_chunk_equals_eager(case, stand_in, monkeypatch):
    """Two chained 25-step checked edge chunks through the executor (two
    captures, plain and FMS-due, each once; the second chunk donates
    the first one's state) equal the eager ones, state, telemetry and
    packs bit for bit."""
    backend, flags = CASES[case]
    s0 = build_pair(32, 24, geom="cluster",
                    pair_matrix=backend == "dense")[1]
    if backend != "dense":
        s0 = tasas.refresh_spatial_sort(s0, tasas.AsasConfig(), block=32,
                                        impl=tasas.impl_for_backend(backend))
    cfg = tstep.SimConfig(cd_backend=backend, cd_block=32, **flags)
    snaps = {}
    for graphed in (True, False):
        monkeypatch.setattr(tstep, "_graphed", lambda state: graphed)
        one = tstep.run_steps_edge(s0, cfg, 25, checked=True)
        first = _snap(one)
        two = tstep.run_steps_edge(one[0], cfg, 25, checked=True,
                                   sort_t0=_sort_t(one))
        snaps[graphed] = (first, _snap(two))
        if graphed:
            assert len(stand_in) == 2
            assert two[0].ac.lat.data_ptr() == one[0].ac.lat.data_ptr()
            assert float(two[1].simt) == float(two[0].simt)
        else:
            assert int(one[1].nconf_cur) > 0
    for g, e in zip(snaps[True], snaps[False]):
        _assert_snaps_equal(g, e)


def _assert_equal_np(a, b):
    bad = [k for k in a if not np.array_equal(a[k], b[k], equal_nan=True)]
    assert not bad, bad


@pytest.mark.parametrize("backend", ["dense", "tiled"])
def test_donation_and_keep_contract(stand_in, backend):
    """A returned state that is not passed back stays valid; passing it
    back advances its buffers in place; ``run_steps_edge_keep`` writes
    neither its input nor a state it returned; telemetry survives the
    next chunk.  Tiled states have an empty ``resopairs``, whose data
    pointer every empty tensor shares."""
    a, b = (build_pair(32, 24, geom="cluster", seed=s,
                       pair_matrix=backend == "dense")[1] for s in (0, 1))
    cfg = tstep.SimConfig(cd_backend=backend, cd_block=32)
    out_a = tstep.run_steps(a, cfg, 5)
    out_a2, tel = tstep.run_steps_edge(out_a, cfg, 5)
    assert out_a2.ac.lat.data_ptr() == out_a.ac.lat.data_ptr()
    assert float(out_a2.simt) == float(tel.simt) > float(out_a.simt)
    tel_np = [t.clone() for t in tel]
    snap = _numpy(out_a2)
    out_b = tstep.run_steps(b, cfg, 5)
    assert out_b.ac.lat.data_ptr() != out_a2.ac.lat.data_ptr()
    _assert_equal_np(_numpy(out_a2), snap)

    k1, _ = tstep.run_steps_edge_keep(out_a2, cfg, 5)
    k1_np = _numpy(k1)
    k2, _ = tstep.run_steps_edge_keep(k1, cfg, 5)
    _assert_equal_np(_numpy(out_a2), snap)
    _assert_equal_np(_numpy(k1), k1_np)
    assert k2.ac.lat.data_ptr() != k1.ac.lat.data_ptr()
    tstep.run_steps_edge(out_a2, cfg, 5)
    assert all(torch.equal(x, y) for x, y in zip(tel, tel_np))


def test_config_switch_and_release_reuse_buffers(stand_in):
    """A returned state chunked under another configuration (a stack
    command switched the resolver) donates its buffers to that
    configuration's executor, and the executor it came from is dropped;
    after ``graph.release`` of a returned state its executor reuses its
    buffers for another state.  Each chunk equals the eager steps."""
    def eager(state, cfg, n=5):
        s = _tcopy(state)
        for _ in range(n):
            s = tstep.step(s, cfg)
        return _numpy(s)

    a = build_pair(32, 24, geom="cluster", pair_matrix=True)[1]
    mvp = tstep.SimConfig(cd_block=32)
    eby = mvp._replace(asas=tasas.AsasConfig(reso_method="EBY"))
    out = tstep.run_steps(a, mvp, 5)
    want = eager(out, eby)
    out2 = tstep.run_steps(out, eby, 5)
    assert out2.ac.lat.data_ptr() == out.ac.lat.data_ptr()
    assert len([ex for ex in graph._CHUNKS.values() if ex.owns(out2)]) == 1
    _assert_equal_np(_numpy(out2), want)
    kept = tstep.run_steps_edge_keep(out2, eby, 5)[0]
    assert kept.ac.lat.data_ptr() != out2.ac.lat.data_ptr()
    want = eager(kept, eby)
    graph.release(out2)
    out3 = tstep.run_steps(kept, eby, 5)
    assert out3.ac.lat.data_ptr() == out2.ac.lat.data_ptr()
    _assert_equal_np(_numpy(out3), want)


def test_write_back_clones_what_it_overwrites():
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    graph.write_back([a, b], [b, a])
    assert a.tolist() == [10, 11, 12, 13] and b.tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        graph.write_back([a], [a.double()])


def test_gate_schedule_follows_step(stand_in, monkeypatch):
    """200 steps at ``fms_dt`` 1.01 s through chunks of 7, 13, 20, 60 and
    100 steps take the (fms, asas) decisions of 200 ``step`` calls, at
    the same host clocks (the CD interval is a stub: the gates are under
    test)."""
    tstate = build_pair(8, 4, seed=2, pair_matrix=True)[1]
    calls = []
    body = tstep.step_body

    def record(state, cfg, fms, asas, simt, gen):
        calls.append((fms, asas, simt.clone() if torch.is_tensor(simt)
                      else simt))
        return body(state, cfg, fms, False, simt, gen)
    monkeypatch.setattr(tstep, "step_body", record)
    cfg = tstep.SimConfig(fms_dt=1.01)

    monkeypatch.setattr(tstep, "_graphed", lambda state: False)
    s = tstate
    for _ in range(200):
        s = tstep.step(s, cfg)
    eager, calls[:] = list(calls), []

    monkeypatch.setattr(tstep, "_graphed", lambda state: True)
    g = tstate
    for n in (7, 13, 20, 60, 100):
        g = tstep.run_steps(g, cfg, n)
    # the stand-in replays run the captured body, which records the
    # pattern it was captured with, and the device clock it reads
    assert [(f, a, float(t)) for f, a, t in calls] \
        == [(f, a, float(t)) for f, a, t in eager]
    assert sum(c[0] for c in eager) >= 9 and sum(c[1] for c in eager) == 10
    for k in ("simt", "fms_t0", "asas_tnext"):
        assert getattr(g, k) == getattr(s, k)
