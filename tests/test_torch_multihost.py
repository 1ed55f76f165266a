"""Several processes on ``torch.distributed`` (``parallel/sharding.
init_multihost``, ``parallel/dist``), the cross-rank fingerprint, the
killed peer and the ensemble functions, on the CPU.

* Two gloo CPU processes (``scripts/torch_multihost.py``), each owning 2
  of 4 shards, step JAX's ``tests/test_sharding.make_mixed_scene`` (768
  slots) in the replicate mode of the sparse and of the pallas backend,
  and a regional scene (600 aircraft in 1024 slots, denser than JAX's
  ``tests/test_spatial.make_scene`` so that conflicts cross the shard
  edges) in the spatial and the 2x2 tiles modes, for 25 steps: each
  rank's state is bit-equal to the port's single-device run of the mode
  (JAX ``tests/test_multihost.py``), and the join counters show the
  traffic.
* The port's single-device run of the mixed scene against one
  module-scoped JAX ``run_steps`` reference of the same sparse backend
  (Pallas in interpret mode: its compile is ~40 s of this file's worker
  time): flags, counts and partner sets equal, positions within 1e-5
  deg, every other float within rtol 1e-3 / atol 5e-2: the clump puts
  ~350 aircraft in 0.2 x 0.2 deg, and the float32 pair sums of both
  kernels over that many intruders, taken in different orders, move
  the resolution commands by up to 4e-4 of their size and the commanded
  altitudes by centimetres (ten times ``tests/test_torch_shard.py``'s
  single-interval CD tolerance, rtol 1e-4 / atol 5e-3).
* A peer SIGKILLed mid-run: rank 0's ``MeshGuard.guarded_ready`` raises
  ``MeshLostError`` naming it within the dispatch and heartbeat budgets,
  and the run resumed from the last snapshot on the survivor's shards is
  bit-equal to a fresh run from that snapshot (JAX
  ``tests/test_meshchaos.py``, first case).
* A replicated state that differs across ranks raises at the chunk edge.
* The ensemble: 8 replicas on an 8 x CPU ``("ens",)`` mesh, each
  bit-equal to its solo run and within 1e-9 of JAX's solo run (JAX
  ``tests/test_sharding.py::test_ensemble_replicas_match_individual_runs``).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core.step import SimConfig as JSimConfig, run_steps as jrun
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu_torch.core import step as tstep
from bluesky_tpu_torch.core.state import state_from_numpy, state_to_numpy
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
from bluesky_tpu_torch.parallel import sharding

from torch_parity import jax_tree_to_numpy, partner_sets

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "scripts", "torch_multihost.py")
STEPS = 25

sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_multihost as multihost  # noqa: E402



def mixed_inputs(n=700, seed=7):
    """JAX ``make_mixed_scene``'s creation inputs: half a dense clump,
    half a continental spread."""
    rng = np.random.default_rng(seed)
    clump = np.arange(n) % 2 == 0
    lat = np.where(clump, rng.uniform(51.9, 52.1, n),
                   rng.uniform(35.0, 60.0, n))
    lon = np.where(clump, rng.uniform(3.9, 4.1, n),
                   rng.uniform(-10.0, 30.0, n))
    hdg = rng.uniform(0.0, 360.0, n)
    alt = rng.uniform(4900.0, 5100.0, n)
    spd = rng.uniform(140.0, 180.0, n)
    return alt, spd, lat, lon, hdg


def regional_inputs(n=600, seed=7):
    """600 aircraft spread over 4 x 6 deg: dense enough that conflict
    pairs cross every stripe and tile edge of a 4-shard mesh (zeroing a
    peer's slabs changes the result), sparse enough that no shard
    overflows its nmax / 4 caller rows."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(4900.0, 5100.0, n), rng.uniform(140.0, 180.0, n),
            rng.uniform(50.0, 54.0, n), rng.uniform(2.0, 8.0, n),
            rng.uniform(0.0, 360.0, n))


SCENES = {"replicate": (768, mixed_inputs), "pallas": (768, mixed_inputs),
          "spatial": (1024, regional_inputs),
          "tiles": (1024, regional_inputs)}


def torch_scene(mode):
    nmax, inputs = SCENES[mode]
    alt, spd, lat, lon, hdg = inputs()
    traf = TTraffic(nmax=nmax, dtype=torch.float64, pair_matrix=False,
                    device="cpu")
    traf.create(len(lat), "B744", alt, spd, None, lat, lon, hdg)
    traf.flush()
    return traf.state


def single_device(mode, state=None, ndev=4):
    """The port's single-device run of the mode: the same entry into the
    mode as each rank's (``scripts/torch_multihost.enter`` on a 4-shard
    mesh), then ``run_steps`` with no mesh (the tiles mode's
    single-device reference)."""
    st = torch_scene(mode) if state is None else state
    st, cfg = multihost.enter(st, multihost.make_mesh(mode, CPU, ndev, 1),
                              mode)
    return tstep.run_steps(st, cfg, STEPS)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(tmp_path, state, *extra):
    """Two worker processes on ``state`` (written as an npz)."""
    path = str(tmp_path / "in.npz")
    np.savez(path, **state_to_numpy(state))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    return [subprocess.Popen(
        [sys.executable, WORKER, "--rank", str(r), "--world", "2",
         "--port", str(port), "--state", path, "--out", str(tmp_path),
         "--device", "cpu", "--backend", "gloo", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, bad


@pytest.fixture(scope="module")
def jax_mixed():
    """JAX's sparse ``run_steps`` of the mixed scene, float64, 25 steps."""
    alt, spd, lat, lon, hdg = mixed_inputs()
    traf = JTraffic(nmax=768, dtype=jnp.float64, pair_matrix=False)
    traf.create(len(lat), "B744", alt, spd, None, lat, lon, hdg)
    traf.flush()
    return jax_tree_to_numpy(jrun(traf.state, JSimConfig(
        cd_backend="sparse", cd_block=256), STEPS))


@pytest.mark.parametrize("mode", list(SCENES))
def test_two_processes_are_bit_equal_to_one_device(mode, tmp_path):
    procs = start_ranks(tmp_path, torch_scene(mode), "--mode", mode,
                        "--steps", str(STEPS), "--chunks", "1")
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    want = state_to_numpy(single_device(mode))
    assert int(want["asas.nconf_cur"]) > 0, "the scene must conflict"
    assert want["asas.active"].sum() > 0, "resolution must engage"
    for r in (0, 1):
        assert_bit_equal(load(tmp_path / f"rank{r}-{mode}.npz"), want)
        info = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert info["backend"] == "gloo" and not info["staged"]
        assert info["ranks"] == [0, 0, 1, 1]
        (chunk,) = info["chunks"][mode]
        # two ASAS intervals in 25 steps: one join of the shards' results
        # each (the only collective of a mesh interval), moving the
        # peer's two shards
        assert chunk["calls"] == 2
        assert chunk["bytes"] > 0 and chunk["staged_bytes"] == 0


def test_single_device_run_matches_jax(jax_mixed):
    """The port's single-device sparse run (the reference the ranks are
    held to bit for bit) against JAX's run of the same scene."""
    got = state_to_numpy(single_device("replicate"))
    assert sorted(got) == sorted(jax_mixed)
    for k, want in jax_mixed.items():
        x, y = np.asarray(want), np.asarray(got[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        if k in ("asas.partners_s", "asas.partners"):
            assert partner_sets(x) == partner_sets(y), k
        elif x.dtype.kind != "f":
            assert np.array_equal(x, y), k
        elif k.endswith((".lat", ".lon")):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=k)
        else:
            d = np.abs(x - y)
            if k.endswith(("trk", "hdg")):
                d = np.minimum(d, 360.0 - d)
            assert (d <= 5e-2 + 1e-3 * np.abs(x)).all(), (k, d.max())
    assert int(got["asas.nconf_cur"]) == int(jax_mixed["asas.nconf_cur"])


def test_killed_peer_raises_mesh_lost_and_resumes(tmp_path):
    procs = start_ranks(tmp_path, torch_scene("replicate"), "--steps", "20",
                        "--hb", str(tmp_path / "hb"), "--timeout", "5",
                        "--hb-timeout", "1", "--resume-chunks", "3")
    progress = tmp_path / "progress"

    def chunks():
        try:
            return int(progress.read_text())
        except (OSError, ValueError):
            return 0
    try:
        deadline = time.monotonic() + 120
        while chunks() < 2:
            for p in procs:
                assert p.poll() is None, p.communicate()[0][-4000:]
            assert time.monotonic() < deadline, "the job never progressed"
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGKILL)
        t_kill = time.time()
        out0 = procs[0].communicate(timeout=120)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 0, out0[-4000:]
    lost = json.loads((tmp_path / "meshlost.json").read_text())
    assert lost["lost"] == [1] and "peer process(es) [1] silent" \
        in lost["error"]
    assert lost["survivors"] == ["cpu", "cpu"]
    assert lost["time"] - t_kill < 5.0 + 1.0     # timeout + hb_timeout
    snap = state_from_numpy(load(tmp_path / "snap.npz"), device="cpu")
    assert float(snap.simt) > 0
    mesh = sharding.make_mesh(devices=[CPU] * 2)
    run = sharding.sharded_step_fn(mesh, tstep.SimConfig(
        cd_backend="sparse", cd_block=256), nsteps=20)
    for _ in range(3):
        snap = run(snap)
    assert_bit_equal(load(tmp_path / "resumed.npz"), state_to_numpy(snap))


def test_drifted_replica_raises_at_the_chunk_edge(monkeypatch):
    """The ranks' fingerprints differ: ``check_replicas`` raises, naming
    the chunk and each rank's word."""
    state = torch_scene("replicate")
    word = sharding.check_replicas(state, 1)
    monkeypatch.setattr(sharding.dist, "allgather_words",
                        lambda w, guard=None: [w, w ^ 4])
    with pytest.raises(RuntimeError, match="chunk 3: the replicated state "
                       "differs across ranks") as ei:
        sharding.check_replicas(state, 3)
    assert format(word, "08x") in str(ei.value)
    assert format(word ^ 4, "08x") in str(ei.value)


def test_no_float_all_reduce_in_the_joins():
    """The joins are all-gathers summed in shard order: no module of the
    port reduces floats with ``all_reduce``, whose order the transport
    picks."""
    pkg = os.path.join(ROOT, "bluesky_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "all_reduce" not in fh.read(), f


def test_ensemble_replicas_match_individual_runs():
    """8 replicas on an 8-device ensemble mesh (8 x the CPU), 40 steps
    of the default (dense) config: each bit-equal to its solo run, and
    within 1e-9 of JAX's solo run."""
    fields = ("lat", "lon", "alt", "hdg", "trk", "tas", "gs", "vs")

    def scene(seed, pkg):
        rng = np.random.default_rng(seed)
        n = 24
        args = (rng.uniform(4900.0, 5100.0, n), rng.uniform(140.0, 180.0, n),
                None, rng.uniform(51.9, 52.1, n), rng.uniform(3.9, 4.1, n),
                rng.uniform(0.0, 360.0, n))
        alt, spd, _, lat, lon, hdg = args
        if pkg == "jax":
            traf = JTraffic(nmax=32, dtype=jnp.float64)
        else:
            traf = TTraffic(nmax=32, dtype=torch.float64, device="cpu")
        traf.create(n, "B744", alt, spd, None, lat, lon, hdg)
        traf.flush()
        return traf.state

    seeds = range(8)
    emesh = sharding.make_ensemble_mesh(8, devices=[CPU] * 8)
    assert emesh.shape == {"ens": 8}
    out = sharding.ensemble_step_fn(emesh, tstep.SimConfig(), nsteps=40)(
        sharding.stack_replicas([scene(s, "torch") for s in seeds]))
    jcfg = JSimConfig()
    for r in seeds:
        solo = state_to_numpy(tstep.run_steps(scene(r, "torch"),
                                              tstep.SimConfig(), 40))
        jsolo = jax_tree_to_numpy(jrun(scene(r, "jax"), jcfg, 40))
        got = {k: np.asarray(v)[r] for k, v in state_to_numpy(out).items()}
        assert_bit_equal(got, solo)
        for f in fields:
            np.testing.assert_allclose(got[f"ac.{f}"], jsolo[f"ac.{f}"],
                                       rtol=0, atol=1e-9, err_msg=f)
        assert int(got["asas.nconf_cur"]) == int(jsolo["asas.nconf_cur"])


def test_ensemble_joins_the_groups_of_several_devices():
    """An ensemble mesh of two distinct devices, interleaved (the CPU
    under two names, ``cpu`` and ``cpu:0``): each device steps the
    replicas of its shards as one stack and the groups come back in
    replica order, bit-equal to the one-device ensemble."""
    cpu0 = torch.device("cpu", 0)
    assert cpu0 != CPU

    def scene(seed):
        rng = np.random.default_rng(seed)
        n = 24
        traf = TTraffic(nmax=32, dtype=torch.float64, device="cpu")
        traf.create(n, "B744", rng.uniform(4900.0, 5100.0, n),
                    rng.uniform(140.0, 180.0, n), None,
                    rng.uniform(51.9, 52.1, n), rng.uniform(3.9, 4.1, n),
                    rng.uniform(0.0, 360.0, n))
        traf.flush()
        return traf.state

    stack = lambda: sharding.stack_replicas([scene(s) for s in range(8)])
    cfg = tstep.SimConfig()
    two = sharding.make_ensemble_mesh(devices=[CPU, cpu0] * 2)
    one = sharding.make_ensemble_mesh(devices=[CPU] * 4)
    got = state_to_numpy(sharding.ensemble_step_fn(two, cfg, 20)(stack()))
    want = state_to_numpy(sharding.ensemble_step_fn(one, cfg, 20)(stack()))
    assert_bit_equal(got, want)
    assert not np.array_equal(got["ac.lat"][0], got["ac.lat"][2])
