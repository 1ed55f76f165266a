"""Mesh epochs of the port (``parallel/sharding.MeshGuard``,
``MeshLostError``, ``Simulation._handle_mesh_lost``), held against JAX's
``tests/test_meshguard.py``.

* The MeshGuard unit cases of JAX's file, on the port's groups of shard
  positions (a mesh of 8 x the CPU device: group 1 is shards 4-7, the
  survivors the devices of shards 0-3, never deduplicated by device),
  the groups by rank of a mesh that spans processes, and
  ``guarded_ready`` on a collective handle that never completes.
* FAULT MESHKILL on an 8-shard CPU mesh against JAX's 8-device virtual
  mesh, the same commands on both float64 sims: the echoes, the trip
  log, the epoch, ``mesh_health``, ``mesh_events``, HEALTH's and FAULT's
  mesh lines, and the recovered states within the parity tolerances of
  ``tests/torch_parity.py`` (``SIM_RTOL``/``SIM_ATOL`` 1e-9).
* The D=8 -> D=4 re-shard parity: the state stepped after a forced
  re-shard is bit-equal to a fresh 4-shard run restored from the same
  ring blob (JAX ``test_reshard_parity_with_fresh_small_mesh_run``).
* The snapshot's v4 shard header and the cross-mesh restore that resets
  the sort caches (JAX ``TestSnapshotShardHeader``).
* FAULT PARTITION: JAX's echo on a detached sim, and the heartbeat-only
  drop of the port's injector.
"""
import os
import time

import numpy as np
import pytest
import torch

from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.fault import harness, injectors
from bluesky_tpu_torch.parallel import sharding
from bluesky_tpu_torch.parallel.sharding import MeshGuard, MeshLostError
from bluesky_tpu_torch.simulation import snapshot as snap

from torch_parity import assert_sim_states, no_pacing, sim_do, sim_pair

CPU = torch.device("cpu")


@pytest.fixture()
def pair(monkeypatch):
    """The JAX and the port's float64 sims (nmax 16), the port's SHARD
    seeing 8 CPU shards as JAX's sees the conftest's 8 CPU devices."""
    no_pacing(monkeypatch)
    monkeypatch.setattr(sharding, "default_devices",
                        lambda device=None: [CPU] * 8)
    return sim_pair(nmax=16)


def fleet(sim, n=3):
    for i in range(n):
        sim_do(sim, f"CRE KL{i} B744 {52 + i} {4 + i} 90 FL{200 + 10 * i} "
               "250")
    sim.op()


# ------------------------------------------------------------ MeshGuard

def test_single_process_partition_is_two_halves():
    assert MeshGuard._partition(list(range(8))) == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]
    assert MeshGuard._partition([1]) == [[1]]
    assert MeshGuard._partition([]) == []
    # a mesh spanning processes: one group per rank, in rank order
    assert MeshGuard._partition([0, 1, 2, 3], [1, 1, 0, 0]) == [[2, 3],
                                                               [0, 1]]


def test_groups_are_shard_positions_on_a_repeated_device():
    """Eight shards of one device: group 1 is shards 4-7 and the
    survivors are four devices (not one deduplicated device)."""
    g = MeshGuard(mesh=sharding.make_mesh(devices=[CPU] * 8))
    assert g.groups == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert g.kill_group(1) == [4, 5, 6, 7]
    assert g.survivors == [CPU] * 4
    g = MeshGuard(mesh=sharding.make_tile_mesh((2, 2), devices=[CPU] * 4))
    assert g.groups == [[0, 1], [2, 3]]


def test_kill_group_validates_and_keeps_one_alive():
    g = MeshGuard()
    g.groups = [[0, 1], [2, 3]]
    with pytest.raises(ValueError):
        g.kill_group(2)
    assert g.kill_group(1) == [2, 3]
    assert g.survivors == [0, 1]
    with pytest.raises(ValueError):        # never kill the last
        g.kill_group(0)


def test_check_raises_structured_error_only_with_mesh():
    g = MeshGuard()
    g._killed = {0}
    g.check()                  # no mesh bound: nothing to lose
    g.set_mesh(sharding.make_mesh(devices=[CPU] * 8))
    g.kill_group(1)
    with pytest.raises(MeshLostError) as ei:
        g.check()
    assert ei.value.lost_groups == (1,)
    assert len(ei.value.survivors) == 4
    assert str(ei.value) == ("mesh epoch 0: device group(s) 1 dead "
                             "(4 device(s) survive)")


def test_set_mesh_clears_kill_marks():
    g = MeshGuard(mesh=sharding.make_mesh(devices=[CPU] * 8))
    g.kill_group(1)
    g.set_mesh(sharding.make_mesh(devices=[CPU] * 4))
    g.check()                  # a new epoch starts healthy


def test_stale_peers_from_heartbeat_stamps(tmp_path):
    g = MeshGuard(heartbeat_dir=str(tmp_path), hb_timeout=5.0)
    g.stamp()                               # own stamp: never stale
    peer = tmp_path / "meshhb-7"
    peer.write_text("0.0\n")
    old = time.time() - 60.0
    os.utime(peer, (old, old))
    assert g.stale_peers() == [7]
    assert g.stale_peers(hb_timeout=120.0) == []


def test_guarded_ready_times_out_on_stale_peer(tmp_path):
    """A collective handle that never completes (polled, never waited
    on) with a peer whose stamp is stale: MeshLostError names it."""
    g = MeshGuard(heartbeat_dir=str(tmp_path), timeout=0.3, hb_timeout=0.1)
    peer = tmp_path / "meshhb-9"
    peer.write_text("0.0\n")
    old = time.time() - 60.0
    os.utime(peer, (old, old))

    class Hang:
        def is_completed(self):
            return False

        def wait(self):
            time.sleep(30.0)
    t0 = time.monotonic()
    with pytest.raises(MeshLostError) as ei:
        g.guarded_ready(Hang())
    assert 9 in ei.value.lost_groups
    assert time.monotonic() - t0 < 5.0
    assert (tmp_path / "meshhb-0").is_file()     # it stamped while waiting


def test_guarded_ready_timeout_without_stale_peer_and_failure():
    g = MeshGuard(timeout=0.2, hb_timeout=0.1)

    class Hang:
        def is_completed(self):
            return False
    with pytest.raises(MeshLostError, match="exceeded 0.2s"):
        g.guarded_ready(Hang())

    class Failed:
        def is_completed(self):
            return True

        def wait(self):
            raise RuntimeError("connection reset")
    # every peer alive: the transport's own error comes back
    with pytest.raises(RuntimeError, match="connection reset"):
        g.guarded_ready(Failed())


def test_guarded_ready_returns_soon_after_the_work_completes(tmp_path):
    """The wait polls the work far more often than it stamps the
    heartbeat: with a 5 s budget (a 1 s beat) a collective that finishes
    after 50 ms is seen within a few ms, not at the next beat."""
    g = MeshGuard(heartbeat_dir=str(tmp_path), timeout=5.0, hb_timeout=2.0)
    t0 = time.monotonic()

    class Done:
        def is_completed(self):
            return time.monotonic() - t0 > 0.05

        def wait(self):
            pass
    g.guarded_ready(Done())
    assert time.monotonic() - t0 < 0.25
    assert (tmp_path / "meshhb-0").is_file()


def test_guarded_ready_passthrough_when_healthy():
    g = MeshGuard(timeout=5.0)
    x = torch.arange(4.0)
    out = g.guarded_ready(x)
    assert torch.equal(out, torch.arange(4.0))


# ----------------------------------------------------- FAULT MESHKILL e2e

def test_meshkill_trips_and_resharding_recovers(pair):
    """JAX ``test_meshkill_trips_and_resharding_recovers`` on both sims:
    the same echoes, trip log, epoch, HEALTH/FAULT mesh lines and
    MESHLOST notice; the recovered states within 1e-9."""
    jsim, tsim = pair
    for sim in pair:
        fleet(sim)
    assert sim_do(tsim, "SHARD REPLICATE 8") \
        == sim_do(jsim, "SHARD REPLICATE 8")
    out = {}
    for sim in pair:
        sim.snap_ring.dt = 1.0        # force frequent ring captures
        sim.run(until_simt=4.0)
        assert len(sim.snap_ring)     # a restore point exists
        out[sim] = sim_do(sim, "FAULT MESHKILL 1")
        assert "marked dead" in out[sim][-1]
        sim.run(until_simt=6.0)       # trips at the next dispatch
    assert out[tsim] == out[jsim]
    for sim in pair:
        actions = [t["action"] for t in sim.guard.trips]
        assert actions == ["mesh_lost", "resharded"]
        lost = next(t for t in sim.guard.trips
                    if t["action"] == "mesh_lost")
        assert lost["source"] == "mesh_guard" and lost["ndev"] == 8
        assert sim.mesh_epoch == 1 and sim.shard_mode == "replicate"
        assert sim.shard_mesh.shape["ac"] == 4
        assert sim.traf.ntraf == 3    # the fleet survived the epoch change
    strip = lambda t: {k: v for k, v in t.items() if k != "error"}
    assert [strip(t) for t in tsim.guard.trips] \
        == [strip(t) for t in jsim.guard.trips]
    mh = tsim.mesh_health()
    assert mh == dict(epoch=1, devices=4, mode="replicate",
                      last_refresh_ms=mh["last_refresh_ms"], degraded=True)
    jmh = jsim.mesh_health()
    assert {k: v for k, v in mh.items() if k != "last_refresh_ms"} \
        == {k: v for k, v in jmh.items() if k != "last_refresh_ms"}
    assert tsim.mesh_events == jsim.mesh_events
    (ev,) = tsim.mesh_events
    assert ev["recovered"] and ev["prev_ndev"] == 8 \
        and ev["ndev"] == 4 and ev["degraded"]
    techo, jecho = sim_do(tsim, "FAULT"), sim_do(jsim, "FAULT")
    assert techo == jecho
    assert any("MESH EPOCH 1: REPLICATE on 4 device(s) [degraded], "
               "restored from ring" in e for e in techo)
    th, jh = sim_do(tsim, "HEALTH")[-1], sim_do(jsim, "HEALTH")[-1]
    assert th.split("mesh:")[1].split(", last refresh")[0] \
        == jh.split("mesh:")[1].split(", last refresh")[0]
    assert "[DEGRADED]" in th
    assert_sim_states(jsim, tsim)


def test_meshkill_requires_an_active_mesh(pair):
    for sim in pair:
        fleet(sim)
    (jok, jmsg), (tok, tmsg) = (harness_of(s)(s, "MESHKILL") for s in pair)
    assert (tok, tmsg) == (jok, jmsg)
    assert not tok and "SHARD first" in tmsg


def harness_of(sim):
    """The FAULT function of the sim's own package."""
    if type(sim).__module__.startswith("bluesky_tpu_torch"):
        return harness.fault_command
    from bluesky_tpu.fault import harness as jharness
    return jharness.fault_command


def test_fault_status_and_health_report_the_mesh_epoch(pair):
    for sim in pair:
        fleet(sim)
        sim_do(sim, "SHARD REPLICATE 8")
    (jok, jmsg), (tok, tmsg) = (harness_of(s)(s) for s in pair)
    assert (tok, tmsg) == (jok, jmsg)
    assert tok and "mesh: epoch 0, 8 device(s)" in tmsg
    out = sim_do(pair[1], "HEALTH")[-1]
    assert "mesh: epoch 0" in out and "mode replicate" in out


def state_arrays(sim):
    sim.traf.flush()
    return {k: np.array(v, copy=True)
            for k, v in state_to_numpy(sim.traf.state).items()}


def test_reshard_parity_with_fresh_small_mesh_run(pair):
    """Acceptance: the state stepped after a forced D=8 -> D=4 re-shard
    is bit-equal to a fresh D=4 run restored from the SAME ring blob
    (the port), and within 1e-9 of JAX's recovered run."""
    from bluesky_tpu_torch.simulation.sim import Simulation
    jsim, tsim = pair
    for sim in pair:
        sim.pipeline_enabled = False
        fleet(sim)
        sim_do(sim, "SHARD REPLICATE 8")
        sim.snap_ring.dt = 1.0
        sim.run(until_simt=4.0)
    blob = tsim.snap_ring.newest()
    assert blob is not None
    assert blob["shard"] == dict(mode="replicate", ndev=8, halo_blocks=0)
    restore_simt = snap.blob_simt(blob)
    for sim in pair:
        sim.mesh_guard.kill_group(1)
        sim.run(until_simt=restore_simt + 3.0)   # lose + recover + step
        assert sim.mesh_epoch == 1 and sim.shard_mesh.shape["ac"] == 4
    a, t_a = state_arrays(tsim), tsim.simt

    fresh = Simulation(nmax=16, dtype=torch.float64, device="cpu")
    fresh.pipeline_enabled = False
    ok, msg = snap.restore_blob(fresh, blob, full_reset=False)
    assert ok, msg
    fresh.set_shard("replicate", 4, devices=[CPU] * 4)   # = the survivors
    fresh.op()
    fresh.run(until_simt=restore_simt + 3.0)
    b = state_arrays(fresh)
    assert abs(t_a - fresh.simt) < 1e-9
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_sim_states(jsim, tsim)


def test_snapshot_header_and_cross_mesh_restore(pair, tmp_path):
    """The v4 header carries the 8-shard layout; a blob of the 8-shard
    sim restored into an unsharded sim resets the sorted-space caches
    (JAX ``test_v4_roundtrip_carries_shard_layout`` and
    ``test_cross_mesh_restore_resets_sort_caches``)."""
    from bluesky_tpu_torch.simulation.sim import Simulation
    sim = pair[1]
    fleet(sim)
    sim_do(sim, "SHARD REPLICATE 8")
    sim.run(until_simt=2.0)
    path = str(tmp_path / "mesh.snap")
    blob = snap.state_blob(sim)
    assert blob["shard"] == dict(mode="replicate", ndev=8, halo_blocks=0)
    snap.write_blob(blob, path)
    shard, err = snap.peek_shard(path)
    assert err is None and shard == blob["shard"]
    other = Simulation(nmax=16, dtype=torch.float64, device="cpu")
    ok, msg = snap.restore_blob(other, blob, full_reset=False)
    assert ok, msg
    assert other._sort_simt == -1.0       # re-sort/re-bucket forced
    assert (other.traf.state.asas.partners_s == -1).all()


# --------------------------------------------------------- FAULT PARTITION

def test_partition_needs_a_network_node(pair):
    (jok, jmsg), (tok, tmsg) = (harness_of(s)(s, "PARTITION") for s in pair)
    assert (tok, tmsg) == (jok, jmsg)
    assert not tok and "no network node" in tmsg


def test_partition_injector_drops_heartbeats_only():
    sent = []

    class Sock:
        def send_multipart(self, frames, **kw):
            sent.append(list(frames))

    class Node:
        event_io = Sock()

    node = Node()
    flaky = injectors.partition(node)
    node.event_io.send_multipart([b"PONG", b"payload"])
    node.event_io.send_multipart([b"BATCHWORLD", b"payload"])
    assert sent == [[b"BATCHWORLD", b"payload"]]
    assert flaky.n_name_dropped == 1
    injectors.partition(node, names=())     # heal
    node.event_io.send_multipart([b"PONG", b"payload"])
    assert sent[-1] == [b"PONG", b"payload"]
