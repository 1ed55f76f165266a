"""Device observability of the port (``obs/devprof.py``, ``utils/
profiler.py``, the PROFILE command; ROADMAP A10.5), after JAX's
``tests/test_devprof.py``, on the CPU.

* Compile telemetry: a dispatch that makes a new executor in the graph
  pool is a miss, once; an off-ladder CHUNKSTEPS lands in the off-ladder
  counter, ladder chunks count as warm-up, repeats are hits; HEALTH
  shows the split; the telemetry knob turns the accounting off; a
  capture or a build reports its wall time into every subscribed
  registry (the build through ``ops/_cuda._finish_build``).
* Memory: a forced sample sets the live and peak gauges from the bytes
  of the state's tensors (on the CPU), the total is their sum, the peak
  never falls; with ``devprof_mem_dt`` 0 the unforced sample is a no-op;
  the knob throttles it.
* PROFILE DEVICE: a window over two chunks (on a 4-shard CPU mesh, as
  JAX's runs on its 8-device one) writes a ``torch.profiler`` Chrome
  trace into its directory, one ``device_profile`` span and two
  ``devprof_chunk`` events with the pinned fields, and two observations
  of each chunk histogram; a second request is refused while one is
  open; a bad count is refused; the echoes of PROFILE are JAX's.
* The report: ``scripts/torch_devprof_report.py`` on the recorder dump
  and the Chrome trace of a ``PROFILE DEVICE 2`` window prints one
  table row per ``devprof_chunk`` event and merges both families on
  one time axis.
* The off path: with every feature off the hooks change nothing, and a
  run with the telemetry and the memory sample on is bit-equal to one
  with both off.
* The fabric: the port's server reads the gauges the port's worker now
  writes (the heartbeat's metric deltas): HEALTH's fleet compile split
  and the mitigator's memory repack act on them.
"""
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bluesky_tpu_torch import settings
from bluesky_tpu_torch.core import graph
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.obs import devprof
from bluesky_tpu_torch.obs.trace import get_recorder
from bluesky_tpu_torch.ops import _cuda
from bluesky_tpu_torch.parallel import sharding
from bluesky_tpu_torch.simulation.sim import Simulation

from torch_parity import no_pacing, sim_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def sim(monkeypatch):
    no_pacing(monkeypatch)
    graph.clear()       # the pool is the process's: start with none
    return Simulation(nmax=16, device="cpu")


@pytest.fixture(autouse=True)
def _recorder_reset():
    rec = get_recorder()
    yield
    rec.disable()
    rec.clear()


def do(sim, *lines):
    for line in lines:
        sim.stack.stack(line)
    sim.stack.process()
    out = "\n".join(sim.scr.echobuf)
    sim.scr.echobuf.clear()
    return out


def _fleet(sim, n=3):
    for i in range(n):
        do(sim, f"CRE KL{i} B744 {52 + i} {4 + i} 90 FL{200 + 10 * i} 250")


# -------------------------------------------------------- compile telemetry
def test_offladder_chunksteps_misses_exactly_once(sim):
    assert 7 not in Simulation.CHUNK_LADDER
    _fleet(sim)
    do(sim, "CHUNKSTEPS 7")
    sim.op()
    off = sim.obs.counter("devprof_cache_misses_offladder")
    sim.run(until_simt=sim.simt + 14 * sim.simdt)
    assert off.value == 1
    hits0 = sim.obs.counter("devprof_cache_hits").value
    assert hits0 >= 1
    sim.run(until_simt=sim.simt + 14 * sim.simdt)
    assert off.value == 1
    assert sim.obs.counter("devprof_cache_hits").value > hits0
    assert "off-ladder 1" in sim.devprof.compile_summary()
    assert sim.obs.counter("devprof_cache_misses_ladder").value == 0


def test_ladder_chunks_count_as_warmup(sim):
    _fleet(sim)
    sim.op()
    sim.run(until_simt=sim.simt + 2 * sim.chunk_steps * sim.simdt)
    assert sim.chunk_steps in Simulation.CHUNK_LADDER
    assert sim.obs.counter("devprof_cache_misses_ladder").value >= 1
    assert sim.obs.counter("devprof_cache_misses_offladder").value == 0


def test_a_new_configuration_is_a_new_key(sim):
    """The key is the graph pool's: the same chunk length under another
    configuration (CDMETHOD) is a miss again."""
    _fleet(sim)
    sim.op()
    sim.run(until_simt=sim.simt + 2 * sim.chunk_steps * sim.simdt)
    warm = sim.obs.counter("devprof_cache_misses_ladder").value
    do(sim, "CDMETHOD SPARSE")
    sim.run(until_simt=sim.simt + 2 * sim.chunk_steps * sim.simdt)
    assert sim.obs.counter("devprof_cache_misses_ladder").value == warm + 1


def test_health_reports_the_compile_split(sim):
    _fleet(sim)
    sim.op()
    sim.run(until_simt=sim.simt + sim.chunk_steps * sim.simdt)
    out = do(sim, "HEALTH")
    assert "compiles: ladder warm-up" in out and "off-ladder" in out


def test_telemetry_knob_disables_accounting(sim, monkeypatch):
    monkeypatch.setattr(settings, "devprof_compile_telemetry", False)
    sim.devprof.note_dispatch("edge", 7, 16, 1, True)
    sim.devprof.note_dispatch("edge", 7, 16, 1, False)
    assert sim.obs.counter("devprof_cache_misses_offladder").value == 0
    assert sim.obs.counter("devprof_cache_hits").value == 0


def test_misses_are_the_graph_pools(sim):
    """A miss is a dispatch that made a new executor: after the pool is
    cleared the same chunk is a miss again (no second key set)."""
    _fleet(sim)
    sim.op()
    sim.run(until_simt=sim.simt + 2 * sim.chunk_steps * sim.simdt)
    warm = sim.obs.counter("devprof_cache_misses_ladder").value
    hits = sim.obs.counter("devprof_cache_hits").value
    assert warm == 1 and hits >= 1
    graph.clear()
    sim.run(until_simt=sim.simt + 2 * sim.chunk_steps * sim.simdt)
    assert sim.obs.counter("devprof_cache_misses_ladder").value == warm + 1


def test_compile_events_reach_every_registry(sim, tmp_path):
    """A capture and a build report into each subscribed Simulation's
    registry (JAX: the jax.monitoring listener)."""
    other = Simulation(nmax=16, device="cpu")
    devprof.compile_event("capture_warmup", 3.0)
    devprof.compile_event("capture", 2.0)
    tmp = tmp_path / "lib.so.tmp"
    tmp.write_bytes(b"")
    proc = subprocess.Popen(["true"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    _cuda._finish_build("x.cu", (proc, str(tmp), str(tmp_path / "lib.so"),
                                 time.perf_counter()))
    for s in (sim, other):
        assert s.obs.get("devprof_compile_trace_ms").count == 1
        assert s.obs.get("devprof_compile_lower_ms").count == 1
        assert s.obs.get("devprof_compile_backend_ms").count == 1
        assert s.obs.get("devprof_backend_compiles").value == 2
    assert "backend compiles 2" in sim.devprof.compile_summary()


# -------------------------------------------------------- memory watermarks
def test_forced_sample_sets_gauges_and_peak(sim):
    _fleet(sim)
    sim.op()
    sim.run(until_simt=sim.simt + sim.simdt)
    per = sim.devprof.sample_memory(force=True)
    state_bytes = sum(t.untyped_storage().nbytes()
                      for t in devprof._state_tensors(sim.traf.state))
    assert per == {0: state_bytes} and state_bytes > 0
    total = sim.obs.get("devprof_live_bytes_total")
    assert total.value == sum(per.values())
    (live, peak), = sim.devprof.watermarks().values()
    assert peak >= live == state_bytes
    do(sim, "DEL KL0")
    sim.devprof.sample_memory(force=True)
    assert sim.devprof.watermarks()[0][1] >= peak


def test_unforced_sample_is_noop_with_dt_zero(sim):
    assert settings.devprof_mem_dt == 0.0
    assert sim.devprof.sample_memory() is None
    assert sim.obs.get("devprof_live_bytes_total") is None


def test_throttle_honors_mem_dt(sim, monkeypatch):
    monkeypatch.setattr(settings, "devprof_mem_dt", 100.0)
    assert sim.devprof.sample_memory(now=0.0) is not None
    assert sim.devprof.sample_memory(now=50.0) is None
    assert sim.devprof.sample_memory(now=150.0) is not None


def test_chunk_edges_sample_with_the_knob(sim, monkeypatch):
    monkeypatch.setattr(settings, "devprof_mem_dt", 1e-6)
    _fleet(sim)
    sim.op()
    sim.run(until_simt=sim.simt + 2 * sim.chunk_steps * sim.simdt)
    assert sim.obs.get("devprof_live_bytes_total").value > 0


def test_donation_check_counts_copied_inputs(sim, monkeypatch):
    a, b = torch.ones(8), torch.zeros(4)
    state, out = {"a": a, "b": b}, {"a": a, "b": b.clone()}
    assert sim.devprof.check_donation(state, out) == 0      # knob off
    monkeypatch.setattr(settings, "devprof_donation_check", True)
    assert sim.devprof.check_donation(state, out) == 1
    assert sim.obs.counter("devprof_donation_missed").value == 1


# ------------------------------------------------------- PROFILE DEVICE
def test_window_on_a_4_shard_mesh_traces_and_attributes(sim, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(settings, "trace_dir", str(tmp_path))
    monkeypatch.setattr(sharding, "default_devices",
                        lambda *a, **k: [torch.device("cpu")] * 4)
    rec = get_recorder()
    rec.clear()
    rec.enable()
    _fleet(sim)
    do(sim, "CDMETHOD SPARSE", "SHARD REPLICATE 4")
    assert sim.shard_mode == "replicate"
    sim.op()
    sim.run(until_simt=sim.simt + 2 * sim.chunk_steps * sim.simdt)
    sim.drain_pipeline()
    devdir = str(tmp_path / "devprof")
    out = do(sim, f"PROFILE DEVICE 2 {devdir}")
    assert "2 chunk" in out and devdir in out
    try:
        sim.run(until_simt=sim.simt + 4 * sim.chunk_steps * sim.simdt)
        sim.drain_pipeline()
    finally:
        sim.devprof.abort_window()
    assert not sim.devprof.window_active
    (win,) = sim.devprof.windows
    assert win["n_chunks"] == 2 and len(win["chunks"]) == 2
    traces = glob.glob(os.path.join(devdir, "devprof-*.json"))
    assert traces == [win["trace"]]
    with open(win["trace"]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    names = [e["name"] for e in rec._ring]
    assert names.count("device_profile") == 1
    chunks = [e for e in rec._ring if e["name"] == "devprof_chunk"]
    assert len(chunks) == 2
    for ev in chunks:
        for k in ("seq", "chunk", "compute_ms", "halo_ms", "edge_ms"):
            assert k in ev["args"], k
    prof = next(e for e in rec._ring if e["name"] == "device_profile")
    assert prof["args"]["dir"] == devdir and prof["args"]["n_chunks"] == 2
    for h in ("devprof_compute_ms", "devprof_halo_ms", "devprof_edge_ms"):
        assert sim.obs.get(h).count == 2
    assert sim.obs.counter("devprof_windows").value == 1


def test_second_window_request_refused_while_active(sim, tmp_path):
    _fleet(sim)
    do(sim, f"PROFILE DEVICE 3 {tmp_path / 'd'}")
    try:
        sim.op()
        sim.run(until_simt=sim.simt + sim.simdt)
        assert sim.devprof.window_active
        assert "active" in do(sim, "PROFILE DEVICE").lower()
    finally:
        sim.devprof.abort_window()
    assert not sim.devprof.window_active


def test_profile_echoes_match_jax(monkeypatch, tmp_path):
    """PROFILE's refusals and its window echo answer as JAX's do."""
    from bluesky_tpu import settings as jsettings
    for mod in (settings, jsettings):
        monkeypatch.setattr(mod, "trace_dir", str(tmp_path))
    jsim, tsim = sim_pair()
    for line in ("PROFILE DEVICE 0", "PROFILE DEVICE x", "PROFILE KERNELS",
                 "PROFILE DEEP", "PROFILE FOO", "PROFILE DEVICE 2",
                 "PROFILE TRACE", "PROFILE TRACE ON", "PROFILE TRACE OFF"):
        assert do(tsim, line) == do(jsim, line), line
    jsim.devprof.abort_window()
    tsim.devprof.abort_window()


def test_profile_start_stop_kernels_and_deep(sim, tmp_path):
    """PROFILE START/STOP write a torch.profiler trace; KERNELS and DEEP
    report their timings on each backend (JAX's names)."""
    _fleet(sim, 5)
    out = do(sim, f"PROFILE START {tmp_path / 'tr'}")
    assert "capturing to" in out
    assert "running" in do(sim, "PROFILE START")
    sim.op()
    sim.run(until_simt=sim.simt + sim.simdt)
    out = do(sim, "PROFILE STOP")
    path = out.split("written to ")[1].strip()
    assert os.path.getsize(path) > 0
    assert "no trace" in do(sim, "PROFILE STOP")
    want = {"dense": ("step_chunk[5]", "cd_detect", "mvp_resolve"),
            "tiled": ("cd_tiled",), "pallas": ("cd_pallas",),
            "sparse": ("cd_pallas", "cd_sched")}
    for method, keys in want.items():
        do(sim, f"CDMETHOD {method.upper()}")
        out = do(sim, "PROFILE KERNELS 5")
        assert f"({method} backend)" in out and "aircraft-steps/s" in out
        assert all(f"  {k}: " in out for k in keys), (method, out)
        deep = do(sim, "PROFILE DEEP")
        assert "spatial_permutation" in deep and "device memory" in deep
        probes = ("cd_sweep", "cd_all_inactive", "cd_unsorted", "mvp_tail")
        assert all((p in deep) == (method != "dense") for p in probes), deep


def test_devprof_report_merges_both_families(sim, tmp_path, monkeypatch):
    """``scripts/torch_devprof_report.py`` on the recorder dump and the
    Chrome trace of a CPU ``PROFILE DEVICE 2``: the printed table has
    one row per ``devprof_chunk`` event with its numbers, and the merged
    JSON holds the recorder's events and the profiler's, the profiler's
    moved onto the recorder's axis (inside the window's span)."""
    monkeypatch.setattr(settings, "trace_dir", str(tmp_path))
    rec = get_recorder()
    rec.clear()
    rec.enable()
    _fleet(sim)
    devdir = str(tmp_path / "devprof")
    do(sim, "OP", f"PROFILE DEVICE 2 {devdir}")
    try:
        sim.run(until_simt=sim.simt + 4 * sim.chunk_steps * sim.simdt)
        sim.drain_pipeline()
    finally:
        sim.devprof.abort_window()
    dump = do(sim, "TRACE DUMP").split("written to ")[1].strip()
    merged = str(tmp_path / "merged.json")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "torch_devprof_report.py"),
         dump, "--profile-dir", devdir, "-o", merged],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    head = lines.index(next(ln for ln in lines if ln.split()[:2]
                            == ["seq", "chunk"]))
    rows = [ln.split() for ln in lines[head + 2:]]
    chunks = sorted((e for e in rec._ring if e["name"] == "devprof_chunk"),
                    key=lambda e: e["args"]["seq"])
    assert len(rows) == len(chunks) == 2
    for row, ev in zip(rows, chunks):
        a = ev["args"]
        tot = a["compute_ms"] + a["halo_ms"] + a["edge_ms"]
        assert row == [str(a["seq"]), str(a["chunk"]),
                       f"{a['compute_ms']:.2f}", f"{a['halo_ms']:.2f}",
                       f"{a['edge_ms']:.2f}",
                       f"{100.0 * a['compute_ms'] / tot:.1f}%"]
    with open(merged) as fh:
        doc = json.load(fh)
    evs = doc["traceEvents"]
    assert sum(e.get("name") == "devprof_chunk" for e in evs) == 2
    span = next(e for e in evs if e.get("name") == "device_profile")
    ops = [e["ts"] for e in evs if e.get("cat") == "cpu_op"]
    assert ops and span["ts"] <= min(ops) and max(ops) \
        <= span["ts"] + span["dur"]
    assert doc["metadata"]["sources"][0] == dump


# -------------------------------------------------------------- off path
def test_window_off_path_changes_nothing(sim):
    assert sim.devprof.begin_chunk(1) is False
    sim.devprof.note_chunk(1, 20, 1.0, 0.5)
    sim.devprof.note_edge(1, 0.2)
    assert sim.obs.get("devprof_compute_ms") is None
    assert sim.devprof.windows == []


def test_features_on_leave_the_run_bit_equal(monkeypatch):
    """The telemetry and the memory sample at every edge change no bit
    of the stepped state (the hooks are host bookkeeping only)."""
    no_pacing(monkeypatch)
    states = []
    for on in (False, True):
        monkeypatch.setattr(settings, "devprof_compile_telemetry", on)
        monkeypatch.setattr(settings, "devprof_mem_dt", 1e-6 if on else 0.0)
        s = Simulation(nmax=16, device="cpu")
        _fleet(s, 4)
        do(s, "CDMETHOD SPARSE", "ASAS ON")
        s.op()
        s.run(until_simt=3.0)
        s.drain_pipeline()
        assert (s.obs.get("devprof_live_bytes_total") is not None) == on
        states.append({k: np.array(v, copy=True) for k, v in
                       state_to_numpy(s.traf.state).items()})
    for k in states[0]:
        assert np.array_equal(states[0][k], states[1][k], equal_nan=True), k


# ------------------------------------------------------------ the fabric
def test_server_health_and_mitigator_read_the_gauges(tmp_path,
                                                     monkeypatch):
    """A torch worker's heartbeats carry its devprof counters and memory
    gauge: the server's HEALTH shows a non-zero fleet compile split, and
    the mitigator repacks the worlds on the live bytes."""
    pytest.importorskip("zmq")
    from test_torch_server import Fabric, _scn
    no_pacing(monkeypatch)
    monkeypatch.setattr(settings, "devprof_mem_dt", 1e-6)
    graph.clear()       # the worker's first chunk is then a miss
    f = Fabric(tmp_path, mitigate_enabled=True, world_batch_max=8)
    try:
        f.server.mitigator.mem_budget = 1000
        f.client.stack(f"BATCH {_scn(tmp_path, [('DP', ['CRE DP1 B744 52 4 90 FL200 250'])])}")
        live = lambda: getattr(f.server.fleet.get("devprof_live_bytes_total"),
                               "value", 0)
        assert f.wait(lambda: live() > 0, timeout=60), "no memory gauge"
        perf = f.server.health_payload()["perf"]
        assert perf["fleet_ladder_warmups"] >= 1
        assert "compiles fleet-wide: 0 ladder" not in \
            f.server.health_payload()["text"]
        assert f.wait(lambda: f.server.world_batch_max < 8, timeout=30), \
            "the mitigator never repacked"
    finally:
        f.close()
