"""The shard modes of the sparse backend on a single-process mesh
(``bluesky_tpu_torch/parallel/sharding.py``), on the CPU.

* The walker's mesh forms (``cd_pallas.MeshForm``), plain versions: the
  row subset, the ``col0`` halo window and the gid table each give the
  full pass restricted to the same rows and columns, bit for bit (the
  port's counterpart of JAX's ``tests/test_cd_pallas_col0.py``).
* The sparse step under SHARD REPLICATE, SPATIAL and TILE at 2 and 4
  shards (and the pallas backend's replicate split) is bit-equal to the
  single-device reference of its mode, as JAX's ``tests/test_sharding.py``
  and ``test_spatial.py`` hold JAX's meshes.
* The port's single-device spatial and tiles references against JAX's
  single-chip references (``detect_resolve_sched`` with ``shard_mode``
  and no mesh, Pallas in interpret mode), a fresh and a resumed
  interval, with the tolerances of ``tests/test_torch_cd_sched.py``.
* SHARD OFF, REPLICATE, SPATIAL and TILE through the stack, JAX's
  refusals (not sparse, a wrong TILE shape, too many devices) with JAX's
  echo; a snapshot of a tiles sim restored onto the same and another
  tile shape (JAX's ``test_tiles_snapshot_v4_roundtrip_across_shapes``);
  the in-chunk shard refresh's composed slot bijection; the worlds
  refusal and ``n_partials``.
The port's meshes repeat the CPU device; JAX's are the conftest's
virtual CPU devices.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core.asas import AsasConfig as JAsasConfig
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu.ops import cd_sched as jsched, cr_mvp as jmvp
from bluesky_tpu.parallel import sharding as jshard
from bluesky_tpu_torch.core import step as tstep
from bluesky_tpu_torch.core.state import _tree_map, state_to_numpy
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp
from bluesky_tpu_torch.ops.cd_pallas import MeshForm
from bluesky_tpu_torch.parallel import sharding

from torch_parity import FT, NM, no_pacing, partner_sets, sim_do, slab64

CPU = torch.device("cpu")
BLOCK = 64
RPZ, HPZ, TLOOK = 5 * NM, 1000 * FT, 300.0


def fleet(n, seed=7, wide=False):
    """Creation inputs of ``n`` aircraft a few stripes wide, dense enough
    for conflicts in the first interval, or with ``wide`` the continental
    spread of JAX's ``tests/test_spatial.py`` (35-60 N, 10 W-30 E)."""
    rng = np.random.default_rng(seed)
    box = ((35.0, 60.0), (-10.0, 30.0)) if wide else ((50.0, 54.0),
                                                      (2.0, 8.0))
    return (rng.uniform(4900, 5100, n), rng.uniform(140, 180, n),
            rng.uniform(*box[0], n), rng.uniform(*box[1], n),
            rng.uniform(0, 360, n))


def torch_state(n=200, nmax=512, seed=7):
    alt, spd, lat, lon, hdg = fleet(n, seed)
    traf = TTraffic(nmax=nmax, dtype=torch.float32, pair_matrix=False,
                    device="cpu")
    traf.create(n, "B744", alt, spd, None, lat, lon, hdg)
    traf.flush()
    return traf.state


def clone(state):
    return _tree_map(lambda name, x: x.clone()
                     if isinstance(x, torch.Tensor) else x, state)


def assert_states_equal(a, b):
    A, B = state_to_numpy(a), state_to_numpy(b)
    bad = [k for k in A if not np.array_equal(np.asarray(A[k]),
                                              np.asarray(B[k]),
                                              equal_nan=True)]
    assert not bad, bad
    assert (a.simt, a.asas_tnext) == (b.simt, b.asas_tnext)


def params():
    mvp = cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                           tlookahead=TLOOK)
    return cd_pallas.tile_params(RPZ, HPZ, TLOOK, mvp, RPZ * 1.05)


@functools.lru_cache(maxsize=None)
def operands():
    """The sparse operands of ``torch_state``'s fleet, its second interval
    (a partner table from the first)."""
    st = torch_state()
    ac = st.ac
    cols = (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, st.asas.noreso)
    n_tot = cd_sched.padded_size(st.nmax, BLOCK)
    table = torch.full((n_tot, 8), -1, dtype=torch.int32)
    x = cd_sched.prepare(*cols, RPZ, HPZ, TLOOK, table, block=BLOCK)
    table = cd_sched.run_kernels(x, params())[11].transpose(1, 2) \
        .reshape(n_tot, 8).contiguous()
    return cd_sched.prepare(*cols, RPZ, HPZ, TLOOK, table, block=BLOCK,
                            perm=x.perm)


def visited(wst, wln, wmax, ncols):
    """[rows, ncols] bool: the blocks the windows visit."""
    out = torch.zeros((wst.shape[0], ncols), dtype=torch.bool)
    for i in range(wst.shape[0]):
        for b, k in zip(wst[i].tolist(), wln[i].tolist()):
            out[i, b:min(b + min(k, wmax), ncols)] = True
    return out


def assert_outs_equal(got, want):
    assert len(got) == len(want)
    for j, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), j


def test_mesh_forms_give_the_restricted_full_pass():
    """Each plain mesh form against the single-device pass over the same
    rows and the same global column blocks, bit for bit: K1's row subset
    (rows 1, 5, ... of a 4-shard split), halo window (a shard's rows
    against a window starting at block 1, ``col0`` 1) and gid table
    (those rows against the blocks they reach, ranked by id); K2's row
    subset and window and K3's row subset."""
    x, p = operands(), params()
    assert int(x.pold.ge(0).sum()) > 0
    nb, D = x.nb, 4
    rows = torch.arange(1, nb, D)
    # K1, row subset: the single-device launch's rows
    form = MeshForm(own=x.packed[rows], row0=1, rstride=D)
    got = cd_sched.sched_tiles_plain(x.packed, x.wst[rows], x.wln[rows],
                                     x.wmax, x.pold[rows], p, mesh=form)
    whole = cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                       x.pold, p)
    assert_outs_equal(got, [o[rows] for o in whole])
    # K1, halo window (the fleet fills the first blocks): the full pass
    # over the windows' blocks
    nb_l = nb // D
    r0, r1, c0, c1 = 1, nb_l + 1, 1, 2 * nb_l
    st, ln, _ = cd_sched.build_windows(x.reach[r0:r1, c0:c1], 6, x.wmax,
                                       pad_start=c1 - c0)
    st = torch.clamp(st, 0, c1 - c0)
    form = MeshForm(own=x.packed[r0:r1], row0=r0, col0=c0)
    got = cd_sched.sched_tiles_plain(x.packed[c0:c1], st, ln, x.wmax,
                                     x.pold[r0:r1], p, mesh=form)
    reach = torch.zeros((nb, nb), dtype=torch.bool)
    reach[r0:r1, c0:c1] = visited(st, ln, x.wmax, c1 - c0)
    assert int(reach.sum()) > 0
    want = cd_pallas.full_grid_resume_plain(x.packed, reach, x.pold, p)
    assert_outs_equal(got, [o[r0:r1] for o in want])
    # K1, gid table: the present set of the blocks the rows reach
    rr = x.reach[r0:r1]
    present = torch.nonzero(rr.any(0)).reshape(-1)
    order, gid, wst, wln = cd_sched._tile_windows(
        rr, present, nb, max(6, -(-present.numel() // x.wmax)), x.wmax)
    form = MeshForm(own=x.packed[r0:r1], row0=r0, gid=gid)
    got = cd_sched.sched_tiles_plain(x.packed[present[order]], wst, wln,
                                     x.wmax, x.pold[r0:r1], p, mesh=form)
    reach = torch.zeros((nb, nb), dtype=torch.bool)
    reach[r0:r1, gid.long()] = visited(wst, wln, x.wmax, present.numel())
    want = cd_pallas.full_grid_resume_plain(x.packed, reach, x.pold, p)
    assert_outs_equal(got, [o[r0:r1] for o in want])
    # K2 (every row taken as an overflow row): row subset and window
    reach_f = x.reach
    form = MeshForm(own=x.packed[rows], row0=1, rstride=D)
    got = cd_pallas.full_grid_resume_plain(x.packed, reach_f[rows],
                                           x.pold[rows], p, mesh=form)
    whole = cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold, p)
    assert_outs_equal(got, [o[rows] for o in whole])
    r0, r1, c0, c1 = 0, nb_l, 1, 2 * nb_l
    form = MeshForm(own=x.packed[r0:r1], row0=r0, col0=c0)
    got = cd_pallas.full_grid_resume_plain(
        x.packed[c0:c1], reach_f[r0:r1, c0:c1], x.pold[r0:r1], p, mesh=form)
    reach = torch.zeros_like(reach_f)
    reach[r0:r1, c0:c1] = reach_f[r0:r1, c0:c1]
    assert int(reach.sum()) > 0
    want = cd_pallas.full_grid_resume_plain(x.packed, reach, x.pold, p)
    assert_outs_equal(got, [o[r0:r1] for o in want])
    # K3 (no partner table): row subset
    got = cd_pallas.full_grid_plain(
        x.packed, x.reach[rows], p,
        mesh=MeshForm(own=x.packed[rows], row0=1, rstride=D))
    whole = cd_pallas.full_grid_plain(x.packed, x.reach, p)
    assert_outs_equal(got, [o[rows] for o in whole])


def test_mesh_forms_lift_partner_ids_to_global_slots():
    """JAX ``test_col0_partner_ids_are_global``: the candidate and merged
    partner ids of a window pass are global slot ids, and the pair
    exclusion uses the global id (a row's own block inside its window
    never pairs an aircraft with itself)."""
    x, p = operands(), params()
    r0, r1, c0 = 0, 6, 1                 # the fleet's first blocks
    form = MeshForm(own=x.packed[r0:r1], row0=r0, col0=c0)
    outs = cd_pallas.full_grid_plain(x.packed[c0:], x.reach[r0:r1, c0:], p,
                                     mesh=form)
    ids = outs[9][outs[8] < cd_pallas._BIG]
    assert ids.numel() > 0
    assert int(ids.min()) >= c0 * BLOCK
    own = (torch.arange(r0, r1)[:, None, None]) * BLOCK \
        + torch.arange(BLOCK)[None, None, :]
    assert not ((outs[9] == own) & (outs[8] < cd_pallas._BIG)).any()


def prepared(mode, D, nmax=512, n=200):
    """``torch_state``'s fleet entered into ``mode`` on ``D`` CPU shards:
    ``(state, cfg, mesh)``."""
    st = torch_state(n, nmax)
    devs = [CPU] * D
    cfg = tstep.SimConfig(cd_backend="sparse", cd_block=BLOCK)
    if mode == "spatial":
        mesh = sharding.make_mesh(D, devices=devs)
        st, _, info = sharding.prepare_spatial(st, mesh, cfg.asas,
                                               block=BLOCK)
        cfg = cfg._replace(cd_shard_mode="spatial",
                           cd_halo_blocks=info["halo_blocks"])
    elif mode == "tiles":
        tiles = (2, D // 2)
        mesh = sharding.make_tile_mesh(tiles, devices=devs)
        st, _, info = sharding.prepare_tiles(st, mesh, cfg.asas,
                                             block=BLOCK)
        cfg = cfg._replace(cd_shard_mode="tiles",
                           cd_tile_shape=tuple(info["tile_shape"]),
                           cd_tile_budgets=tuple(info["budgets"]))
    else:
        mesh = sharding.make_mesh(D, devices=devs)
        if mode == "pallas":
            cfg = cfg._replace(cd_backend="pallas")
    return st, cfg, mesh


@pytest.mark.parametrize("mode,D", [("replicate", 2), ("replicate", 4),
                                    ("spatial", 2), ("spatial", 4),
                                    ("tiles", 2), ("tiles", 4),
                                    ("pallas", 4)])
def test_mesh_step_is_bit_equal_to_its_reference(mode, D, monkeypatch):
    """25 steps (two ASAS intervals and an FMS boundary) on the mesh and
    on the single-device reference of the mode (the same prepared state
    and config without the mesh): every state tensor bit-equal, and the
    mesh path taken (each mode's shard work runs)."""
    st, cfg, mesh = prepared(mode, D)
    calls = []
    for name in ("_replicate_rows", "_spatial_mesh", "_tiles_mesh"):
        f = getattr(cd_sched, name)
        monkeypatch.setattr(cd_sched, name, lambda *a, f=f, name=name, **k:
                            (calls.append(name), f(*a, **k))[1])
    f = cd_pallas.full_grid_rows
    monkeypatch.setattr(cd_pallas, "full_grid_rows", lambda *a, **k: (
        calls.append("full_grid_rows"), f(*a, **k))[1])
    ref = tstep.run_steps(clone(st), cfg, 25)
    assert not calls
    out = sharding.sharded_step_fn(mesh, cfg, nsteps=25)(clone(st))
    assert set(calls) == {{"replicate": "_replicate_rows",
                           "spatial": "_spatial_mesh",
                           "tiles": "_tiles_mesh",
                           "pallas": "full_grid_rows"}[mode]}
    assert int(ref.asas.nconf_cur) > 0 and int(ref.asas.active.sum()) > 0
    assert_states_equal(out, ref)


# ------------------------------------------- against JAX's references

def jax_prepared(mode, D):
    """JAX's state of ``torch_state``'s fleet entered into ``mode`` (no
    placement) and its layout info."""
    alt, spd, lat, lon, hdg = fleet(200)
    traf = JTraffic(nmax=512, dtype=jnp.float32, pair_matrix=False)
    traf.create(200, "B744", alt, spd, None, lat, lon, hdg)
    traf.flush()
    if mode == "spatial":
        return jshard.prepare_spatial(traf.state, jshard.make_mesh(D),
                                      JAsasConfig(), block=BLOCK, put=False)
    return jshard.prepare_tiles(traf.state, jshard.make_tile_mesh((2, 2)),
                                JAsasConfig(), block=BLOCK, put=False)


@functools.lru_cache(maxsize=None)
def _jax_fn(mode, extra, tiles, budgets):
    cfg = jmvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                         tlookahead=TLOOK)

    @jax.jit
    def run(cols, perm, partners):
        return jsched.detect_resolve_sched(
            *cols, RPZ, HPZ, TLOOK, cfg, block=BLOCK, interpret=True,
            perm=perm, partners=partners, resume_rpz_m=RPZ * 1.05,
            extra_blocks=extra, shard_mode=mode, tile_shape=tiles or None,
            tile_budgets=budgets)
    return run


@pytest.mark.parametrize("mode", ["spatial", "tiles"])
def test_single_device_references_match_jax(mode):
    """The port's single-device spatial and tiles references against
    JAX's single-chip ones on JAX's prepared layout (sentinel slots for
    the inactive rows), a fresh interval and one resumed from JAX's
    table with the fleet moved 20 s: flags, counts, the engaged flags
    and the partner sets equal, the float reductions within rtol 1e-4 /
    atol 5e-3."""
    js, _, info = jax_prepared(mode, 4)
    ac = js.asas
    extra = info["extra_blocks"]
    tiles = tuple(info.get("tile_shape", ()))
    budgets = tuple(info.get("budgets", ()))
    cfg = cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                           tlookahead=TLOOK)
    perm = np.asarray(ac.sort_perm)
    assert (perm == info["n_tot"]).any()          # sentinel rows
    table = np.asarray(ac.partners_s)
    a = js.ac
    cols = [np.asarray(v) for v in (a.lat, a.lon, a.trk, a.gs, a.alt, a.vs,
                                    a.gseast, a.gsnorth, a.active,
                                    js.asas.noreso)]
    for k in range(2):
        if k:
            cols = list(cols)
            cols[0] = cols[0] + cols[7] * (20 / 111320.0)
            cols[1] = cols[1] + cols[6] * (20 / 70000.0)
        jrd, jp, ja = jax.tree_util.tree_map(np.asarray, _jax_fn(
            mode, extra, tiles, budgets)([jnp.asarray(c) for c in cols],
                                         jnp.asarray(perm),
                                         jnp.asarray(table)))
        trd, tp, ta = cd_sched.detect_resolve_sched(
            *[torch.from_numpy(np.array(c)) for c in cols], RPZ, HPZ, TLOOK,
            cfg, partners=torch.from_numpy(np.array(table)),
            resume_rpz_m=RPZ * 1.05, block=BLOCK, extra_blocks=extra,
            perm=torch.from_numpy(perm), shard_mode=mode,
            tile_shape=tiles or None, tile_budgets=budgets)
        assert int(jrd.nconf) > 0
        for f in ("inconf", "nconf", "nlos"):
            np.testing.assert_array_equal(getattr(trd, f).numpy(),
                                          getattr(jrd, f), err_msg=f)
        # the float sums within the tolerance of JAX's, or, on a row where
        # JAX's float32 misses it (an ill-conditioned MVP pair, ROADMAP
        # §C), of the float64 witness (``tests/test_torch_kpartners.py``)
        s64 = slab64(cols, "tas", cols[3])
        gid = torch.arange(len(cols[0]))
        wit = cd_pallas.row_block_plain(s64, s64, gid, gid, None, params())
        close = lambda a, b: np.isclose(a, b, rtol=1e-4, atol=5e-3)
        missed = np.zeros(len(gid), bool)
        for f, i in (("tcpamax", 1), ("sum_dve", 2), ("sum_dvn", 3),
                     ("sum_dvv", 4), ("tsolv", 5)):
            got, want = getattr(trd, f).numpy(), getattr(jrd, f)
            ok = close(got, want)
            assert (ok | close(got, wit[i].numpy())).all(), f
            missed |= ~ok
        assert int(missed.sum()) <= 2, np.flatnonzero(missed)
        assert partner_sets(trd.topk_idx.numpy()) == partner_sets(
            jrd.topk_idx)
        assert partner_sets(tp.numpy()) == partner_sets(jp)
        np.testing.assert_array_equal(ta.numpy(), ja)
        table = jp
    assert (np.asarray(table) >= 0).any()


# --------------------------------------------------- the Simulation

def shard_sim(nmax=512, n=200, devices=8, monkeypatch=None, wide=False):
    """A port ``Simulation`` on the CPU with ``devices`` CPU devices
    visible to SHARD, ``n`` aircraft of ``fleet``."""
    from bluesky_tpu_torch.simulation.sim import Simulation
    if monkeypatch is not None:
        monkeypatch.setattr(sharding, "default_devices",
                            lambda device=None: [CPU] * devices)
    sim = Simulation(nmax=nmax, device="cpu", pair_matrix=False)
    alt, spd, lat, lon, hdg = fleet(n, seed=3, wide=wide)
    sim.traf.create(n, "B744", alt, spd, None, lat, lon, hdg)
    sim.traf.flush()
    return sim


def test_shard_command_modes_and_refusals(monkeypatch):
    """SHARD through the stack, JAX's refusals with JAX's echo (the JAX
    sim sees the conftest's 8 virtual devices, the port's 8 CPU shards):
    not sparse, a TILE shape that is not the device count, more devices
    than there are; then REPLICATE, SPATIAL and TILE with their readback,
    a creation mid-run that the next refresh re-buckets, HEALTH's mesh
    line, and SHARD OFF restoring the default tables."""
    from bluesky_tpu.simulation.sim import Simulation as JSim
    no_pacing(monkeypatch)
    jsim = JSim(nmax=512)
    sim = shard_sim(monkeypatch=monkeypatch)
    for line in ("SHARD", "SHARD TILE 2x2", "SHARD SPATIAL 4",
                 "CDMETHOD SPARSE", "SHARD TILE 3x5", "SHARD SPATIAL 9",
                 "SHARD REPLICATE 16", "SHARD BOGUS", "SHARD TILE 2xq"):
        jecho, techo = sim_do(jsim, line), sim_do(sim, line)
        assert techo == jecho, line
        assert sim.shard_mode == "off"
    # a tile shape that is not the shard count (set_shard in code)
    with pytest.raises(ValueError) as ej:
        jsim.set_shard("tiles", 8, tiles=(2, 2))
    with pytest.raises(ValueError) as et:
        sim.set_shard("tiles", 8, tiles=(2, 2))
    assert str(et.value) == str(ej.value)
    for line, mode, tokens in (
            ("SHARD REPLICATE 4", "replicate", ("4 devices",)),
            ("SHARD SPATIAL 4", "spatial",
             ("4 devices", "occupancy", "imbalance", "halo",
              "rows/interval")),
            ("SHARD TILE 2x2", "tiles",
             ("4 devices", "2x2", "halo budgets", "rows/interval"))):
        echo = sim_do(sim, line)
        assert sim.shard_mode == mode and sim.cfg.cd_mesh is not None
        assert echo[-1].startswith(f"SHARD {mode.upper()}")
        for t in tokens:
            assert t in echo[-1], (t, echo)
    sim.op()
    sim.run(until_simt=2.0)
    sim_do(sim, "CRE KL001 B744 52 4 90 FL200 250")
    sim.run(until_simt=4.0)
    slot = sim.traf.id2idx("KL001")
    assert abs(float(sim.traf.state.ac.lat[slot]) - 52.0) < 0.3
    perm = sim.traf.state.asas.sort_perm.numpy()
    act = sim.traf.state.ac.active.numpy()
    S_t = sim.traf.state.asas.partners_s.shape[0] // 4
    assert (np.minimum(perm[act] // S_t, 3)
            == (np.arange(512) // 128)[act]).all()
    health = sim_do(sim, "HEALTH")[-1]
    assert "mesh: epoch 0, 4 device(s), mode tiles 2x2" in health
    sim_do(sim, "SHARD OFF")
    assert sim.shard_mode == "off" and sim.cfg.cd_tile_shape == ()
    assert sim.traf.state.asas.partners_s.shape[0] == 512 + 33 * 256
    sim.run(until_simt=5.0)
    assert sim.traf.id2idx("KL001") >= 0


def test_tiles_snapshot_round_trip_across_shapes(tmp_path, monkeypatch):
    """JAX's ``test_tiles_snapshot_v4_roundtrip_across_shapes``: the v4
    shard header carries the tile shape; a blob of a 4x2 tiles sim
    restores into the same layout with its bucketing, and into a 2x2 sim
    with the sorted-space caches reset and a re-bucketing before the
    next chunk."""
    from bluesky_tpu_torch.simulation import snapshot as snap
    no_pacing(monkeypatch)

    def mk(shape):
        sim = shard_sim(monkeypatch=monkeypatch, wide=True)
        sim_do(sim, "CDMETHOD SPARSE", f"SHARD TILE {shape}")
        assert sim.shard_mode == "tiles"
        return sim

    sim = mk("4x2")
    sim.op()
    sim.run(until_simt=2.0)
    blob = snap.state_blob(sim)
    assert blob["shard"]["mode"] == "tiles"
    assert blob["shard"]["tiles"] == [4, 2]
    assert blob["shard"]["ndev"] == 8
    path = str(tmp_path / "tiles.snap")
    snap.write_blob(blob, path)
    shard, err = snap.peek_shard(path)
    assert err is None and shard["tiles"] == [4, 2]
    same = mk("4x2")
    rblob, err = snap.read_blob(path)
    assert err is None, err
    ok, msg = snap.restore_blob(same, rblob, full_reset=False)
    assert ok, msg
    assert same.shard_mode == "tiles"
    np.testing.assert_array_equal(same.traf.state.asas.sort_perm.numpy(),
                                  blob["state"]["asas.sort_perm"])
    same.op()
    same.run(until_simt=3.0)
    assert same.traf.ntraf == 200
    other = mk("2x2")
    rblob, err = snap.read_blob(path)
    ok, msg = snap.restore_blob(other, rblob, full_reset=False)
    assert ok, msg
    assert other.shard_mode == "tiles"
    assert tuple(other.cfg.cd_tile_shape) == (2, 2)
    np.testing.assert_array_equal(other.traf.state.asas.sort_perm.numpy(),
                                  np.arange(512))
    other.op()
    other.run(until_simt=3.0)
    perm = other.traf.state.asas.sort_perm.numpy()
    act = other.traf.state.ac.active.numpy()
    S_t = other.traf.state.asas.partners_s.shape[0] // 4
    assert (np.minimum(perm[act] // S_t, 3)
            == (np.arange(512) // 128)[act]).all()


@pytest.mark.parametrize("mode", ["spatial", "tiles"])
def test_inscan_shard_refresh_composes_the_bijection(mode):
    """The in-chunk spatial or tiles refresh (``inscan_refresh``) over a
    chunk that crosses two refreshes: its RefreshPack's composed slot
    bijection and guard word, and the stepped state, are those of the
    host refreshes run at the same steps (``refresh_*_shard``)."""
    from bluesky_tpu_torch.core import asas as tasas
    st, cfg, mesh = prepared(mode, 4)
    cfg = cfg._replace(cd_mesh=mesh, inscan_refresh=True,
                       asas=cfg.asas._replace(sort_every=1))
    out, _telem, pack = tstep.run_steps_edge(clone(st), cfg, 30)
    assert int(pack.count) == 2 and int(pack.guard) == 0
    ref, composed = clone(st), np.arange(st.nmax)
    host = cfg._replace(inscan_refresh=False)
    for k in range(30):
        if k in (0, 20):
            if mode == "tiles":
                ref, ns, _ = tasas.refresh_tile_shard(
                    ref, cfg.asas, cfg.cd_tile_shape, block=BLOCK,
                    budgets=cfg.cd_tile_budgets)
            else:
                ref, ns, _ = tasas.refresh_spatial_shard(
                    ref, cfg.asas, 4, block=BLOCK,
                    halo_blocks=cfg.cd_halo_blocks)
            composed = ns[composed]
        ref = tstep.step(ref, host)
    np.testing.assert_array_equal(pack.newslot.numpy(), composed)
    assert_states_equal(out, ref)


def test_worlds_refuse_a_sharded_config():
    """JAX ``_check_worlds_cfg``: world batching runs single-device
    configurations, with JAX's message."""
    from bluesky_tpu.core import step as jstep
    st = tstep.stack_worlds([torch_state(40, 64, s) for s in range(2)])
    for kw in (dict(cd_mesh=sharding.make_mesh(2, devices=[CPU] * 2)),
               dict(cd_shard_mode="spatial")):
        cfg = tstep.SimConfig(cd_backend="sparse", cd_block=BLOCK, **kw)
        with pytest.raises(ValueError) as et:
            tstep.step_worlds(st, cfg)
        with pytest.raises(ValueError) as ej:
            jstep._check_worlds_cfg(jstep.SimConfig(cd_shard_mode="spatial"))
        assert str(et.value) == str(ej.value)


def test_n_partials_is_the_shard_count():
    """``scanstats.n_partials`` (and the fingerprint's partials): the
    shard count of a 1-D mesh on ``cd_mesh_axis``, 1 without one or on
    the tile mesh, as JAX's."""
    from bluesky_tpu.core import step as jstep
    from bluesky_tpu.obs import scanstats as jss
    from bluesky_tpu_torch.obs import fingerprint, scanstats
    for D in (1, 2, 4):
        for make, jmake in ((lambda d: sharding.make_mesh(
                d, devices=[CPU] * d), jshard.make_mesh),
                (lambda d: sharding.make_tile_mesh((d, 1), devices=[CPU] * d),
                 lambda d: jshard.make_tile_mesh((d, 1)))):
            cfg = tstep.SimConfig(cd_mesh=make(D))
            jcfg = jstep.SimConfig(cd_mesh=jmake(D))
            assert scanstats.n_partials(cfg, 512) \
                == jss.n_partials(jcfg, 512)
    cfg = tstep.SimConfig(cd_backend="sparse", cd_block=BLOCK,
                          cd_mesh=sharding.make_mesh(4, devices=[CPU] * 4),
                          fingerprint=True, scanstats=True)
    st = torch_state(40, 64)
    assert fingerprint.init(st, cfg).fp.shape == (4,)
    assert scanstats.init(st, cfg).occ_peak.shape == (4,)
