"""The FAULT command and the chaos injectors of the port
(``bluesky_tpu_torch/fault/{harness,injectors}.py``), held against the
JAX package's.

* Every FAULT verb of the usage string through both stacks on the same
  float64 scene: the echoes equal (a detached sim's transport verbs give
  JAX's command error; with a stand-in node whose ``event_io`` records
  the frames, DROP, DUP, DELAY, NETOFF, PARTITION, LOADSPIKE and
  KILLSERVER act as JAX's do), then the guard trips and the states after
  1.5 s of stepping within the parity tolerances of
  ``tests/torch_parity.py`` (1e-9; NaN equal to NaN).
* The guard's responses to the state injectors as JAX's
  ``tests/test_chaos.py`` drives them: quarantine within one chunk,
  rollback with its conditionals, the empty ring, halt, the guard off.
* JAX's FlakySocket cases on the port's injector, the straggle stall
  and throttle, a truncated snapshot, and FAULT KILL in a child process
  (SIGKILL, no goodbye).
"""
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bluesky_tpu_torch.fault import injectors

from torch_parity import (SIM_ATOL, SIM_CMD_FIELDS, SIM_CMD_RTOL, SIM_RTOL,
                          _close, jax_tree_to_numpy, no_pacing, partner_sets,
                          sim_do, sim_pair)

#: the command lines of each case, run after a 3-aircraft fleet flew 2 s
VERBS = {
    "status": ("FAULT",),
    "nan": ("FAULT NAN KL1", "FAULT INF", "FAULT NAN XX", "FAULT LIST"),
    "bitflip": ("FAULT BITFLIP", "FAULT BITFLIP STATE KL2",
                "FAULT BITFLIP KL1", "FAULT BITFLIP PAYLOAD 5",
                "FAULT BITFLIP PAYLOAD x", "FAULT BITFLIP XX"),
    "guard": ("FAULT GUARD", "FAULT GUARD OFF", "FAULT GUARD ON",
              "FAULT GUARD ROLLBACK", "FAULT GUARD HALT",
              "FAULT GUARD QUARANTINE", "FAULT GUARD BOGUS", "FAULT"),
    "ring": ("FAULT RING", "FAULT RING 3 2", "FAULT RING x", "FAULT"),
    "detached transport": ("FAULT DROP 0.5", "FAULT DUP 0.5",
                           "FAULT DELAY 0.1", "FAULT NETOFF", "FAULT OFF",
                           "FAULT PARTITION", "FAULT PARTITION OFF",
                           "FAULT LOADSPIKE 3", "FAULT KILLSERVER"),
    "stall and straggle": ("FAULT STALL 0.01", "FAULT STALL x",
                           "FAULT STRAGGLE 2", "FAULT", "FAULT STRAGGLE x",
                           "FAULT STRAGGLE STALL 0.05",
                           "FAULT STRAGGLE STALL", "FAULT",
                           "FAULT STRAGGLE OFF"),
    "preempt": ("FAULT PREEMPT", "FAULT PREEMPT x"),
    "meshkill": ("FAULT MESHKILL", "FAULT MESHKILL x"),
    "snaptrunc": ("FAULT SNAPTRUNC", "FAULT SNAPTRUNC nofile"),
    "usage": ("FAULT BOGUS", "FAULT LIST"),
}


def fleet(sim, n=3):
    for i in range(n):
        sim_do(sim, f"CRE KL{i} B744 {52 + i} {4 + i} 90 FL{200 + 10 * i} "
               "250")
    sim.op()
    sim.run(until_simt=2.0)


@pytest.fixture()
def pair(monkeypatch):
    no_pacing(monkeypatch)
    jsim, tsim = sim_pair(nmax=16)
    for sim in (jsim, tsim):
        fleet(sim)
    return jsim, tsim


def assert_states(jsim, tsim, poisoned=()):
    """``torch_parity.assert_sim_states`` but for the per-aircraft rows
    of the ``poisoned`` slots: XLA rewrites the heading step's ``turnrate
    * swhdgsel`` into a select, so JAX's NaN-poisoned aircraft keeps a
    finite heading where the port's IEEE product is NaN (ROADMAP §C); the
    guard then deletes the slot and scrubs the port's NaN to 0."""
    from bluesky_tpu_torch.core.state import state_to_numpy
    a = jax_tree_to_numpy(jsim.traf.state)
    b = state_to_numpy(tsim.traf.state)
    keep = np.ones(tsim.traf.nmax, bool)
    keep[list(poisoned)] = False
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        if x.ndim and x.shape[0] == tsim.traf.nmax:
            x, y = x[keep], y[keep]
        if k in ("asas.partners_s", "asas.partners"):
            assert partner_sets(x) == partner_sets(y), k
        elif x.dtype.kind != "f":
            assert np.array_equal(x, y), k
        else:
            _close(k, x, y, SIM_CMD_RTOL if k in SIM_CMD_FIELDS
                   else SIM_RTOL, SIM_ATOL)


def poisoned(echo):
    """The slots the FAULT NAN/INF lines of ``echo`` wrote into."""
    return [int(m) for e in echo
            for m in re.findall(r"injected (?:NAN|INF) into \S+ "
                                r"\(slot (\d+)\)", e)]


def step_both(pair, dt=1.5):
    for sim in pair:
        sim.op()
        sim.run(until_simt=sim.simt + dt)


def trips(sim):
    return [{k: v for k, v in t.items() if k != "simt"} | dict(
        simt=round(t["simt"], 6)) for t in sim.guard.trips]


@pytest.mark.parametrize("case", sorted(VERBS))
def test_fault_verbs_echo_as_jax(case, pair):
    jsim, tsim = pair
    slots = []
    for line in VERBS[case]:
        jecho, techo = sim_do(jsim, line), sim_do(tsim, line)
        assert techo == jecho, line
        assert not any("ROADMAP" in e for e in techo)
        slots += poisoned(techo)
    for attr in ("preempt_requested", "straggle_factor", "straggle_stall",
                 "_fp_corrupt_mask"):
        assert getattr(tsim, attr) == getattr(jsim, attr), attr
    assert (tsim.guard.enabled, tsim.guard.policy) \
        == (jsim.guard.enabled, jsim.guard.policy)
    assert (tsim.snap_ring.depth, tsim.snap_ring.dt) \
        == (jsim.snap_ring.depth, jsim.snap_ring.dt)
    for sim in pair:           # no stall or preemption left to pace on
        sim.straggle_stall = False
        sim.straggle_factor = sim._straggle_debt = 0.0
        sim.preempt_requested = False
    step_both(pair)
    assert trips(tsim) == trips(jsim)
    assert_states(jsim, tsim, slots)


class FakeSock:
    def __init__(self):
        self.sent = []

    def send_multipart(self, frames, **kw):
        self.sent.append(list(frames))


class FakeNode:
    """A networked worker's endpoint as the harness sees it: the event
    socket, ``send_event`` and the broker's pid."""

    def __init__(self, server_pid=None):
        self.event_io = FakeSock()
        self.events = []
        self.server_pid = server_pid

    def send_event(self, name, data=None, route=None):
        self.events.append((name, data))


def test_transport_verbs_on_a_networked_worker(pair, monkeypatch):
    """With a node, DROP/DUP/DELAY install JAX's seeded FlakySocket,
    FAULT reports it, PARTITION drops PONGs only, NETOFF restores the raw
    socket, LOADSPIKE submits synthetic BATCH pieces and KILLSERVER
    kills the broker's pid: echoes and effects as JAX's."""
    jsim, tsim = pair
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"])
             for _ in pair]
    try:
        for sim, p in zip(pair, procs):
            sim.node = FakeNode(server_pid=p.pid)
        for line in ("FAULT DROP 0.25", "FAULT DUP 0.5", "FAULT DELAY 0",
                     "FAULT", "FAULT PARTITION", "FAULT",
                     "FAULT PARTITION OFF", "FAULT NETOFF", "FAULT NETOFF",
                     "FAULT LOADSPIKE 3", "FAULT LOADSPIKE x",
                     "FAULT KILLSERVER x", "FAULT KILLSERVER"):
            jecho = [e.replace(str(procs[0].pid), "<pid>")
                     for e in sim_do(jsim, line)]
            techo = [e.replace(str(procs[1].pid), "<pid>")
                     for e in sim_do(tsim, line)]
            assert techo == jecho, line
        for p in procs:
            assert p.wait(timeout=10) == -signal.SIGKILL
        (jname, jdata), = jsim.node.events
        (tname, tdata), = tsim.node.events
        assert tname == jname == b"BATCH" and tdata["synthetic"]
        assert len(tdata["scencmd"]) == len(jdata["scencmd"]) == 12
        assert tdata["scentime"] == jdata["scentime"]
        assert isinstance(tsim.node.event_io, FakeSock)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_snaptrunc_truncates_as_jax(pair, tmp_path):
    jsim, tsim = pair
    echoes = []
    for sim, d in zip(pair, ("j", "t")):
        os.makedirs(tmp_path / d)
        fname = str(tmp_path / d / "chk.snap")
        with open(fname, "wb") as f:
            f.write(bytes(range(256)) * 8)
        echo = sim_do(sim, f"FAULT SNAPTRUNC {fname[:-5]} 0.25")
        echoes.append([e.replace(f"/{d}/", "/") for e in echo])
        assert os.path.getsize(fname) == 512
    assert echoes[0] == echoes[1]


# ------------------------------------------------ the guard's responses

@pytest.mark.parametrize("policy,lines", [
    ("quarantine", ("FAULT NAN KL1",)),
    ("quarantine", ("FAULT INF KL0",)),
    ("rollback", ("FAULT GUARD ROLLBACK", "KL0 ATALT FL100 ECHO reached",
                  "FAULT NAN KL2")),
    ("empty ring", ("FAULT GUARD ROLLBACK", "FAULT NAN KL0")),
    ("halt", ("FAULT GUARD HALT", "FAULT NAN KL0")),
    ("off", ("FAULT GUARD OFF", "FAULT NAN KL0")),
])
def test_guard_responses_as_jax(policy, lines, pair):
    """JAX's ``TestIntegrityGuard`` on both sims, synchronous chunks:
    the same trips (first bad step, ids, action), conditionals and
    states."""
    jsim, tsim = pair
    for sim in pair:
        sim.pipeline_enabled = False
        if policy == "rollback":
            sim.snap_ring.capture(sim)
        if policy == "empty ring":
            sim.snap_ring.clear()
    slots = []
    for line in lines:
        techo = sim_do(tsim, line)
        assert techo == sim_do(jsim, line), line
        slots += poisoned(techo)
    step_both(pair)
    assert trips(tsim) == trips(jsim)
    assert (tsim.cond.cmd, tsim.traf.ids, tsim.state_flag) \
        == (jsim.cond.cmd, jsim.traf.ids, jsim.state_flag)
    want = {"off": [], "halt": ["halt"], "quarantine": ["quarantine"],
            "empty ring": ["quarantine"],
            "rollback": ["rollback+quarantine"]}[policy]
    assert [t["action"] for t in tsim.guard.trips] == want
    assert_states(jsim, tsim, slots)
    if policy == "quarantine":
        assert tsim.guard.trips[0]["bad_step"] == 0


# ------------------------------------------------------------ injectors

def test_flaky_socket_drop_dup_delay():
    raw = FakeSock()
    flaky = injectors.FlakySocket(raw, p_drop=1.0, seed=1)
    for i in range(10):
        flaky.send_multipart([b"x", bytes([i])])
    assert raw.sent == [] and flaky.n_dropped == 10
    flaky = injectors.FlakySocket(raw, p_dup=1.0, seed=1)
    for i in range(5):
        flaky.send_multipart([bytes([i])])
    assert len(raw.sent) == 10 and flaky.n_duped == 5
    raw = FakeSock()
    flaky = injectors.FlakySocket(raw, delay_s=0.05, seed=1)
    flaky.send_multipart([b"late"])
    assert raw.sent == [] and flaky.n_delayed == 1
    time.sleep(0.06)
    flaky.flush()
    assert raw.sent == [[b"late"]]


def test_install_remove_flaky_round_trip():
    """Re-wrapping updates the wrapper; removing it delivers the frames
    that were merely late and restores the raw socket."""
    ep = FakeNode()
    raw = ep.event_io
    injectors.install_flaky(ep, p_drop=0.5)
    assert isinstance(ep.event_io, injectors.FlakySocket)
    flaky = injectors.install_flaky(ep, p_drop=0.0, delay_s=60.0)
    assert ep.event_io.wrapped is raw and flaky.p_drop == 0.0
    flaky.send_multipart([b"held"])
    assert raw.sent == []
    assert injectors.remove_flaky(ep)
    assert raw.sent == [[b"held"]] and ep.event_io is raw
    assert not injectors.remove_flaky(ep)


def test_straggle_stall_and_throttle(monkeypatch):
    """STRAGGLE STALL freezes simt while the loop keeps turning; a
    factor owes wall time per simulated second, paid in slices."""
    from bluesky_tpu_torch.simulation.sim import Simulation
    no_pacing(monkeypatch)
    sim = Simulation(nmax=16, dtype=torch.float64, device="cpu")
    fleet(sim, n=1)
    injectors.straggle(sim, stall_progress=True)
    t0 = sim.simt
    for _ in range(5):
        sim.step()
    assert sim.simt == t0
    injectors.straggle(sim, factor=2.0)
    assert not sim.straggle_stall
    sim.step()
    assert sim._straggle_debt > 0 and sim.simt > t0
    timer = injectors.straggle(sim, stall_progress=True, stall_s=0.05)
    timer.join(2.0)
    assert not sim.straggle_stall


def test_truncated_snapshot_load_fails_gracefully(monkeypatch, tmp_path):
    from bluesky_tpu_torch.simulation.sim import Simulation
    no_pacing(monkeypatch)
    sim = Simulation(nmax=16, dtype=torch.float64, device="cpu")
    fleet(sim, n=2)
    fname = str(tmp_path / "chk.snap")
    sim_do(sim, f"SNAPSHOT SAVE {fname}")
    size = os.path.getsize(fname)
    assert injectors.truncate_file(fname, 0.5) == size // 2
    out = "\n".join(sim_do(sim, f"SNAPSHOT LOAD {fname}"))
    assert "corrupt or truncated" in out
    sim.op()
    sim.run(until_simt=sim.simt + 1.0)
    assert sim.traf.ntraf == 2


def test_fault_kill_sigkills_the_process():
    """FAULT KILL: SIGKILL, no goodbye (in a child process)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import torch\n"
            "from bluesky_tpu_torch.simulation.sim import Simulation\n"
            "from bluesky_tpu_torch.fault import harness\n"
            "sim = Simulation(nmax=16, device='cpu')\n"
            "harness.fault_command(sim, 'KILL')\n"
            "print('survived')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=here,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=here))
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    assert "survived" not in p.stdout
