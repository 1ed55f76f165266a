"""World-batched stepping of the port (``core/step.py`` world runners,
``simulation/worlds.py``) on the CPU, where every kernel wrapper runs its
plain PyTorch version.  It mirrors ``tests/test_worlds.py`` and the
detached WORLDS command of ``tests/test_world_serving.py``.

* The port against itself, bit for bit: the stack/unstack round trip; a
  W=1 stack against the unbatched ``run_steps``; four different worlds
  (different aircraft counts, seeds and latitudes) against four solo
  runs, on every CD backend, and on dense with the noise models on (each
  world draws from its own generator); the in-scan refresh, ScanStats
  and fingerprint packs of stacked sparse chunks against solo chunks.
* Against the JAX package's world runners (``run_steps_worlds``,
  ``_checked``, ``_edge``, ``_edge_keep``) on the dense backend, float64,
  the same numpy-seeded worlds: the first-bad-step vector with a NaN in
  world 2 is JAX's; the telemetry at the tolerances of
  ``tests/test_torch_chunk.py`` (ints, bools and ``simt`` equal;
  lat/lon 1e-5 deg, altitude 1e-2 m, the rest rtol 1e-4 / atol 1e-3);
  ScanStats at those of ``tests/test_torch_obs.py`` (ints equal,
  ``min_sep_m`` 3 m, ``headroom_min_m`` 1e-2 m); each world's
  fingerprint fold of the stepped state bit-equal to JAX's vmapped fold
  of the same arrays.
* Sparse and pallas worlds against JAX's unbatched ``run_steps`` of each
  world (float32, JAX's kernels in interpret mode), at the tolerances of
  ``tests/test_torch_slice.py``: counts, flags and partner sets equal,
  lat/lon 1e-5 deg, altitude 1e-2 m, the rest rtol 1e-4 / atol 1e-3.
* The flattened plain kernel calls (slabs of W worlds stacked along the
  row-block axis, world-local windows and reachability, global slot
  ids) against W per-world plain calls, bit for bit, and the world base
  of the work-item builder.
* ``WorldBatch`` against solo ``Simulation``s (bit for bit) and against
  the JAX ``WorldBatch`` (float64, ``torch_parity.assert_sim_states``:
  floats within 1e-9, the resolver commands 1e-7), its progress
  payload against JAX's, and a NaN world under ``quarantine`` that
  recovers alone while the others complete.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import asas as jasas, step as jstep
from bluesky_tpu_torch.core import asas as tasas, graph, step as tstep
from bluesky_tpu_torch.core.noise import NoiseConfig
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.core.traffic import Traffic
from bluesky_tpu_torch.ops import cd_pallas, cd_sched

from torch_parity import (assert_sim_states, build_pair, jax_tree_to_numpy,
                          no_pacing, partner_sets, scene)

BACKENDS = ("dense", "sparse", "pallas", "tiled")
BLOCK = 32
NSTEPS = 41                 # three ASAS intervals, two FMS updates


def _copy(state):
    return graph.rebuild(state, iter([t.clone()
                                      for _, t in graph.leaves(state)]))


def _numpy(state):
    return {k: np.array(v, copy=True)
            for k, v in state_to_numpy(state).items()}


def _assert_equal(a, b):
    a, b = _numpy(a), _numpy(b)
    assert sorted(a) == sorted(b)
    bad = [k for k in a if not np.array_equal(a[k], b[k], equal_nan=True)]
    assert not bad, bad


def _world(n, seed, lat0, backend, nmax=32, dtype=torch.float32):
    """A port state of ``n`` aircraft of the conflict cluster scene moved
    to latitude ``lat0``, sorted for ``backend``."""
    lat, lon, hdg, alt, spd = scene(n, "cluster", seed)
    traf = Traffic(nmax=nmax, dtype=dtype, pair_matrix=backend == "dense",
                   device="cpu")
    traf.create(n, "B744", alt, spd, None, lat - 52.0 + lat0, lon, hdg)
    traf.flush()
    return _sorted(traf.state, backend)


def _sorted(state, backend):
    if backend == "dense":
        return state
    return tasas.refresh_spatial_sort(state, tasas.AsasConfig(), block=BLOCK,
                                      impl=tasas.impl_for_backend(backend))


def _cfg(backend, **kw):
    return tstep.SimConfig(cd_backend=backend, cd_block=BLOCK, **kw)


FOUR = ((12, 0, 35.0), (18, 1, 45.0), (24, 2, 55.0), (30, 3, 65.0))


# ------------------------------------------------------ the port, bit for bit

def test_stack_unstack_round_trip():
    states = [_world(n, s, lat, "sparse") for n, s, lat in FOUR]
    states[2] = tstep.run_steps(states[2], _cfg("sparse"), 3)
    w = tstep.stack_worlds(states)
    assert w.ac.lat.shape == (4, 32) and w.simt.shape == (4,)
    assert w.rng.dtype == np.uint64
    back = tstep.unstack_worlds(w)
    for a, b in zip(states, back):
        _assert_equal(a, b)
        assert (type(b.rng), b.simt.dtype) == (int, a.simt.dtype)
    assert float(back[2].simt) > float(back[0].simt)


@pytest.mark.parametrize("backend", BACKENDS)
def test_w1_bit_parity(backend):
    """A W=1 stack steps as the unbatched runner does, bit for bit."""
    state = _world(24, 0, 52.0, backend)
    ref = tstep.run_steps(_copy(state), _cfg(backend), NSTEPS)
    got = tstep.run_steps_worlds(tstep.stack_worlds([state]),
                                 _cfg(backend), NSTEPS)
    assert int(ref.asas.nconf_cur) > 0
    _assert_equal(ref, tstep.world_slice(got, 0))


@pytest.mark.parametrize("backend,noise", [
    (b, False) for b in BACKENDS] + [("dense", True)],
    ids=lambda p: p if isinstance(p, str) else ("noise" if p else ""))
def test_w4_independent_scenarios(backend, noise):
    """Four different worlds batched equal four solo runs, bit for bit
    (the worlds' clocks differ too: one starts 1 s ahead)."""
    cfg = _cfg(backend, noise=NoiseConfig(turb_active=noise,
                                          adsb_transnoise=noise))
    states = [_world(n, s, lat, backend) for n, s, lat in FOUR]
    states[1] = tstep.run_steps(states[1], cfg, 20)
    states[3].rng = 12345
    refs = [tstep.run_steps(_copy(s), cfg, NSTEPS) for s in states]
    got = tstep.unstack_worlds(tstep.run_steps_worlds(
        tstep.stack_worlds(states), cfg, NSTEPS))
    assert all(int(r.asas.nconf_cur) > 0 for r in refs)
    for ref, g in zip(refs, got):
        _assert_equal(ref, g)
    if noise:
        quiet = tstep.run_steps(_copy(states[0]), _cfg(backend), NSTEPS)
        for f in ("adsb.lat", "ac.alt"):        # the draws moved them
            assert not np.array_equal(_numpy(quiet)[f], _numpy(refs[0])[f])


def test_inscan_refresh_and_packs_match_solo():
    """Stacked sparse chunks with the in-scan refresh, ScanStats, the
    fingerprint and the guard give each world's solo packs, and the
    [W] refresh clocks chain across chunks."""
    cfg = tstep.SimConfig(simdt=0.0625, cd_backend="sparse", cd_block=BLOCK,
                          asas=tasas.AsasConfig(sort_every=2),
                          inscan_refresh=True, scanstats=True,
                          fingerprint=True)
    states = [_world(n, s, lat, "sparse") for n, s, lat in FOUR[:3]]
    solo_t = [None] * 3
    world_t = None
    for _ in range(2):
        refs = [tstep.run_steps_edge(_copy(s), cfg, 40, checked=True,
                                     sort_t0=t)
                for s, t in zip(states, solo_t)]
        out = tstep.run_steps_worlds_edge(tstep.stack_worlds(states), cfg,
                                          40, checked=True, sort_t0=world_t)
        assert len(out) == 5 and out[3].sort_t.shape == (3,)
        for w, ref in enumerate(refs):
            got = tstep.world_slice(out, w)
            _assert_equal(ref[0], got[0])
            for a, b in zip(ref[1:], got[1:]):
                for f in a._fields:
                    x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
                    assert np.array_equal(x, y, equal_nan=True), f
        assert int(out[3].count.sum()) > 0
        states = [r[0] for r in refs]
        solo_t = [r[3].sort_t for r in refs]
        world_t = out[3].sort_t


# ------------------------------------------------- against JAX: dense, f64

GEOMS = (("cluster", 24, 0), ("box", 20, 1), ("clump", 28, 2),
         ("equator", 16, 3))


@pytest.fixture(scope="module")
def dense64():
    """Four different float64 worlds in both packages (32 slots)."""
    pairs = [build_pair(32, n, geom=g, seed=s, dtype="float64",
                        pair_matrix=True) for g, n, s in GEOMS]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _jcopy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


def _assert_telemetry(tel, jtel):
    """``tests/test_torch_chunk.py``'s telemetry tolerances, per world."""
    assert tel._fields == jtel._fields
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


def test_worlds_runner_matches_jax(dense64):
    jstates, tstates = dense64
    jout = jstep.run_steps_worlds(jstep.stack_worlds(
        [_jcopy(s) for s in jstates]), jstep.SimConfig(), 20)
    tout = tstep.run_steps_worlds(tstep.stack_worlds(
        [_copy(s) for s in tstates]), tstep.SimConfig(), 20)
    nconf = []
    for w in range(4):
        ref = jstep.pack_telemetry(jstep.world_slice(jout, w))
        _assert_telemetry(tstep.pack_telemetry(tstep.world_slice(tout, w)),
                          ref)
        nconf.append(int(ref.nconf_cur))
    assert max(nconf) > 0


def test_checked_pins_world_and_step(dense64):
    """A NaN in a live row of world 2 gives JAX's [W] first-bad-step
    vector; the clean worlds stay bit-equal to their solo runs."""
    jstates, tstates = dense64
    jstates = list(jstates)
    jstates[2] = jstates[2].replace(ac=jstates[2].ac.replace(
        lat=jstates[2].ac.lat.at[1].set(jnp.nan)))
    tstates = [_copy(s) for s in tstates]
    tstates[2].ac.lat[1] = float("nan")
    _, jbad = jstep.run_steps_worlds_checked(
        jstep.stack_worlds([_jcopy(s) for s in jstates]), jstep.SimConfig(),
        20)
    refs = [tstep.run_steps(_copy(s), tstep.SimConfig(), 20)
            for s in tstates]
    wstate, bad = tstep.run_steps_worlds_checked(
        tstep.stack_worlds(tstates), tstep.SimConfig(), 20)
    assert bad.dtype == torch.int32 and bad.shape == (4,)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    assert bad.tolist() == [-1, -1, 0, -1]
    for w in (0, 1, 3):
        _assert_equal(refs[w], tstep.world_slice(wstate, w))


def test_edge_packs_match_jax(dense64):
    """Edge runners with ScanStats and the fingerprint: the [W] telemetry
    and ScanStats against JAX's, each world's fingerprint fold equal to
    JAX's vmapped fold of the same stepped arrays, and ``_keep`` equal to
    the donating runner with its input untouched."""
    from bluesky_tpu.obs import fingerprint as jfp
    from bluesky_tpu_torch.obs import fingerprint as tfp, scanstats as tss
    jstates, tstates = dense64
    jcfg = jstep.SimConfig(scanstats=True, fingerprint=True)
    tcfg = tstep.SimConfig(scanstats=True, fingerprint=True)
    jout = jstep.run_steps_worlds_edge_keep(
        jstep.stack_worlds(jstates), jcfg, 20, checked=True)
    win = tstep.stack_worlds([_copy(s) for s in tstates])
    before = _numpy(win)
    tout = tstep.run_steps_worlds_edge_keep(win, tcfg, 20, checked=True)
    for k, v in _numpy(win).items():
        assert np.array_equal(v, before[k], equal_nan=True), k
    donated = tstep.run_steps_worlds_edge(
        tstep.stack_worlds([_copy(s) for s in tstates]), tcfg, 20,
        checked=True)
    _assert_equal(tout[0], donated[0])
    assert len(tout) == len(jout) == 4
    assert tout[1].bad.tolist() == [-1] * 4
    for w in range(4):
        _assert_telemetry(tstep.world_slice(tout[1], w),
                          jstep.world_slice(jout[1], w))
        tpack, jpack = (tstep.world_slice(tout[2], w),
                        jstep.world_slice(jout[2], w))
        for f in tss.ScanStats._fields:
            t, j = getattr(tpack, f).numpy(), np.asarray(getattr(jpack, f))
            assert t.dtype == j.dtype and t.shape == j.shape, f
            if f == "min_sep_m":
                np.testing.assert_allclose(t, j, rtol=0, atol=3.0, err_msg=f)
            elif f == "headroom_min_m":
                np.testing.assert_allclose(t, j, rtol=0, atol=1e-2,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(t, j, err_msg=f)
        assert int(tout[3].steps[w]) == int(jout[3].steps[w]) == 20
    # the fold of the same [W] arrays: the port's stepped stack as JAX's
    tree = state_to_numpy(tout[0])
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jstep.stack_worlds(jstates))
    jstate = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(tree[jax.tree_util.keystr(p).lstrip(".")])
        for p, _ in leaves])
    jf = jax.vmap(lambda s: jfp.fold(jfp.init(s, jcfg), s, jcfg))(jstate)
    tf = tfp.fold(tfp.init(tout[0], tcfg), tout[0], tcfg)
    assert tf.fp.shape == (4, 1)
    np.testing.assert_array_equal(tf.fp.numpy().astype(np.uint64),
                                  np.asarray(jf.fp).astype(np.uint64))
    # and each world's chunk pack is its solo chunk's
    for w, s in enumerate(tstates):
        solo = tstep.run_steps_edge(_copy(s), tcfg, 20, checked=True)
        assert tfp.combine(solo[3]) == tfp.combine(
            tstep.world_slice(tout[3], w))


# ------------------------------------- against JAX: sparse, pallas (float32)

@pytest.mark.parametrize("backend", ("sparse", "pallas"))
def test_kernel_backends_match_jax_solo(backend):
    """Two worlds stacked through the port's one-launch passes against
    JAX's unbatched ``run_steps`` of each world."""
    pairs = [build_pair(128, n, geom=g, seed=s)
             for g, n, s in (("box", 90, 0), ("cluster", 60, 1))]
    impl = tasas.impl_for_backend(backend)
    jcfg = jstep.SimConfig(cd_backend=backend, cd_block=64)
    tcfg = tstep.SimConfig(cd_backend=backend, cd_block=64)
    refs = [jax_tree_to_numpy(jstep.run_steps(jasas.refresh_spatial_sort(
        j, jcfg.asas, block=64, impl=impl), jcfg, 21)) for j, _ in pairs]
    tstates = [tasas.refresh_spatial_sort(t, tcfg.asas, block=64, impl=impl)
               for _, t in pairs]
    got = tstep.unstack_worlds(tstep.run_steps_worlds(
        tstep.stack_worlds(tstates), tcfg, 21))
    table = "asas.partners_s" if backend == "sparse" else "asas.partners"
    for j, g in zip(refs, got):
        t = state_to_numpy(g)
        assert int(j["asas.nconf_cur"]) > 0
        for k in ("asas.nconf_cur", "asas.nlos_cur", "asas.inconf",
                  "asas.active", "asas.sort_perm", "perf.phase"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert partner_sets(t[table]) == partner_sets(j[table])
        for k in ("ac.lat", "ac.lon"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(t["ac.alt"], j["ac.alt"], rtol=0,
                                   atol=1e-2)
        for k in ("ac.tas", "ac.gs", "ac.vs", "ac.trk", "asas.trk",
                  "asas.tas", "asas.vs", "asas.tcpamax"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-3,
                                       err_msg=k)


# ------------------------------------------ the flattened plain kernel calls

@pytest.fixture(scope="module")
def sparse_worlds():
    """Three sparse worlds stepped past two intervals (engaged partners
    in their tables), stacked."""
    states = [tstep.run_steps(_world(n, s, lat, "sparse"), _cfg("sparse"),
                              NSTEPS) for n, s, lat in FOUR[1:]]
    return states, tstep.stack_worlds(states)


def _cols(state):
    ac = state.ac
    return (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, state.asas.noreso)


def _assert_outs(stacked, per_world, id_base, ids=(9, 11)):
    """Stacked kernel outputs against per-world outputs: every output
    bit-equal, the slot ids (outputs ``ids``: the candidates, and the
    merged partners of the resume passes) of world w shifted by
    ``id_base * w``."""
    for j, got in enumerate(stacked):
        want = []
        for w, outs in enumerate(per_world):
            o = outs[j]
            if j in ids:
                o = torch.where((o >= 0) & (o < cd_pallas._BIG_I),
                                o + w * id_base, o)
            want.append(o)
        torch.testing.assert_close(got, torch.cat(want), rtol=0, atol=0,
                                   equal_nan=True, msg=f"output {j}")


@pytest.mark.parametrize("reso", ("mvp", "eby", "swarm"))
def test_flattened_plain_kernels_equal_per_world(sparse_worlds, reso):
    """K1 (segment pass), K2 (overflow rows) and K3 (full grid) on the
    stacked operands equal W per-world plain calls."""
    states, w = sparse_worlds
    acfg = tasas.AsasConfig()
    p = cd_pallas.tile_params(acfg.rpz, acfg.hpz, acfg.dtlookahead,
                              tasas._mvp_config(acfg), acfg.rpz * 1.05)
    extra = {"tas": w.ac.tas} if reso == "eby" else \
        {"cas": w.ac.cas} if reso == "swarm" else {}
    n_tot = cd_sched.padded_size(32, BLOCK)

    def sched(state, extra_cols):
        return cd_sched.prepare(*_cols(state), acfg.rpz, acfg.hpz,
                                acfg.dtlookahead,
                                state.asas.partners_s[..., :n_tot, :],
                                block=BLOCK, perm=state.asas.sort_perm,
                                reso=reso, **extra_cols)

    x = sched(w, extra)
    xs = [sched(s, {k: v[i] for k, v in extra.items()})
          for i, s in enumerate(states)]
    assert x.packed.shape[0] == 3 * x.nb and x.reach.shape == (3 * x.nb,
                                                                x.nb)
    assert int(x.reach.sum()) > 0
    _assert_outs(cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold,
                                      p, reso=reso, nbw=x.nb),
                 [cd_sched.sched_tiles(y.packed, y.wst, y.wln, y.wmax,
                                       y.pold, p, reso=reso) for y in xs],
                 n_tot)
    _assert_outs(cd_pallas.full_grid_resume(x.packed, x.reach, x.pold, p,
                                            reso=reso),
                 [cd_pallas.full_grid_resume(y.packed, y.reach, y.pold, p,
                                             reso=reso) for y in xs], n_tot)
    # K3 on the operands of the pallas backend
    xp = cd_pallas.prepare(*_cols(w), acfg.rpz, acfg.dtlookahead, block=BLOCK,
                           extra_cols=extra, reso=reso)
    xps = [cd_pallas.prepare(*_cols(s), acfg.rpz, acfg.dtlookahead,
                             block=BLOCK,
                             extra_cols={k: v[i] for k, v in extra.items()},
                             reso=reso) for i, s in enumerate(states)]
    assert xp.worlds == 3
    _assert_outs(cd_pallas.full_grid(xp.packed, xp.reach, p, reso=reso),
                 [cd_pallas.full_grid(y.packed, y.reach, p, reso=reso)
                  for y in xps], xp.nb * xp.block, ids=(9,))


def test_mask_items_world_base(sparse_worlds):
    """The work items of a stacked [W * nbw, nbw] mask are each world's
    items with its first block added."""
    _, w = sparse_worlds
    acfg = tasas.AsasConfig()
    x = cd_sched.prepare(*_cols(w), acfg.rpz, acfg.hpz, acfg.dtlookahead,
                         w.asas.partners_s[..., :cd_sched.padded_size(
                             32, BLOCK), :], block=BLOCK,
                         perm=w.asas.sort_perm)
    got = cd_pallas.mask_items(x.reach, 4, nbw=x.nb)
    for k in range(3):
        rows = slice(k * x.nb, (k + 1) * x.nb)
        one = cd_pallas.mask_items(x.reach[rows], 4)
        np.testing.assert_array_equal(got.start[rows].numpy(),
                                      one.start.numpy())
        np.testing.assert_array_equal(got.length[rows].numpy(),
                                      one.length.numpy())
        count = x.reach[rows].sum(1)
        for i in range(x.nb):
            c = int(count[i])
            np.testing.assert_array_equal(
                got.tiles[rows][i, :c].numpy(),
                one.tiles[i, :c].numpy() + k * x.nb)


# ------------------------------------------------------------- WorldBatch

def _piece(acid, lat, ff=20.0):
    return ([0.0, 0.0, 0.0],
            [f"SCEN {acid}", f"CRE {acid} B744 {lat} 4 90 FL200 250",
             f"FF {ff}"])


PIECES = [_piece("AAA1", 52.0), _piece("BBB2", 48.0), _piece("CCC3", 44.0)]


def _run_solo(piece, **kw):
    from bluesky_tpu_torch.simulation.sim import OP, Simulation
    sim = Simulation(nmax=16, device="cpu", **kw)
    sim.pipeline_enabled = False
    sim.stack.set_scendata(list(piece[0]), list(piece[1]))
    sim.op()
    it = 0
    while sim.state_flag == OP and it < 5000:
        sim.step()
        it += 1
    return sim


def test_worldbatch_matches_solo_and_jax(monkeypatch):
    """Joint dispatches equal solo sims bit for bit and JAX's WorldBatch
    within the Simulation tolerances; ``progress`` is JAX's payload."""
    from bluesky_tpu.simulation.worlds import WorldBatch as JWorldBatch
    from bluesky_tpu_torch.simulation.worlds import WorldBatch
    no_pacing(monkeypatch)
    wb = WorldBatch(PIECES, simkw=dict(nmax=16, device="cpu",
                                       dtype=torch.float64))
    jwb = JWorldBatch(PIECES, simkw=dict(nmax=16, dtype=jnp.float64))
    assert wb.progress() == jwb.progress()
    assert wb.progress()["worlds_done"] == 0
    done = []
    wb.on_world_done = lambda i, status, info: done.append((i, status))
    assert wb.run(max_iters=5000) == ["completed"] * 3
    assert jwb.run(max_iters=5000) == ["completed"] * 3
    assert sorted(done) == [(0, "completed"), (1, "completed"),
                            (2, "completed")]
    assert wb.stats["joint_dispatches"] == jwb.stats["joint_dispatches"] > 0
    assert wb.stats["max_group"] == 3
    assert wb.progress() == jwb.progress()
    assert wb.progress()["worlds_done"] == 3
    for piece, wsim, jsim in zip(PIECES, wb.sims, jwb.sims):
        assert wsim.world_tag == jsim.world_tag
        ref = _run_solo(piece, dtype=torch.float64)
        assert ref.simt == wsim.simt == jsim.simt
        _assert_equal(ref.traf.state, wsim.traf.state)
        assert_sim_states(jsim, wsim)
    # every world completed: a preemption now checkpoints nothing, in
    # either package
    assert wb.handle_preempt() == jwb.handle_preempt() \
        == {"worlds": 3, "done": [0, 1, 2], "checkpoints": []}


def test_worldbatch_quarantines_only_faulty_world(monkeypatch):
    """A NaN injected into one world mid-run trips only that world's
    guard; the other world completes bit-identically to a solo run."""
    from bluesky_tpu_torch.simulation.worlds import WorldBatch
    no_pacing(monkeypatch)
    pieces = [_piece("GOOD1", 52.0), _piece("BAD1", 30.0)]
    wb = WorldBatch(pieces, simkw=dict(nmax=16, device="cpu"))
    assert wb.sims[1].guard.policy == "quarantine"
    assert wb.step()
    bad = wb.sims[1]
    bad.traf.state.ac.tas[0] = float("nan")
    wb.run(max_iters=5000)
    assert wb.status == ["completed", "completed"]
    assert len(bad.guard.trips) >= 1 and bad.traf.ntraf == 0
    assert not wb.sims[0].guard.trips and wb.sims[0].traf.ntraf == 1
    _assert_equal(_run_solo(pieces[0]).traf.state, wb.sims[0].traf.state)
