"""The port's sim worker (``bluesky_tpu_torch.simulation.simnode``) on
the JAX package's serving fabric, on the CPU.

A JAX ``Server(headless=True, spawn_workers=False)`` runs in a thread on
free localhost ports, torch ``SimNode(device="cpu")`` workers run in
threads, and a JAX ``Client`` drives them (the pattern of the JAX
``tests/test_simnode.py``, ``test_batch.py``, ``test_world_serving.py``
and ``test_diff.py``): STACKCMD echo and ACDATA, GETSIMSTATE, STEP
lockstep, BATCH farmed to two workers, a WORLDS pack of four pieces, the
replies of the serving-fabric commands echoed by the worker, an OPT
BATCH piece journalling ``opt_result`` before ``completed``, and
preemption.  The slice parity case feeds the same STACKCMD events to
JAX's ``DetachedSimNode`` and the port's (dense backend, float64) and
holds their ACDATA frames to each other at ``tests/test_torch_sim.py``'s
tolerances (floats within 1e-9, the resolver outputs within 1e-7).
Every wait is bounded; nodes, servers and clients are closed in
``finally``.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from bluesky_tpu.network.client import Client
from bluesky_tpu.network.journal import BatchJournal
from bluesky_tpu.network.server import Server
from bluesky_tpu_torch import settings as tsettings
from bluesky_tpu_torch.simulation.simnode import (DetachedSimNode,
                                                  SimNode, piece_key)
from tests.test_network import free_ports, wait_for

from torch_parity import SIM_ATOL, SIM_CMD_RTOL, SIM_RTOL, no_pacing

OP, HOLD = 2, 1


class Fabric:
    """A JAX server, ``n`` torch workers and a JAX client, started;
    ``close`` stops all of them."""

    def __init__(self, tmp_path=None, n_nodes=1, nmax=16, **serverkw):
        ev, st, wev, wst = free_ports(4)
        self.journal = str(tmp_path / "batch.jsonl") \
            if tmp_path is not None else None
        self.server = Server(headless=True,
                             ports=dict(event=ev, stream=st, wevent=wev,
                                        wstream=wst),
                             spawn_workers=False, journal_path=self.journal,
                             **serverkw)
        self.server.start()
        self.nodes, self.threads = [], []
        self.client = Client()
        self.echoes = []
        self.client.event_received.connect(
            lambda n, d, s: self.echoes.append(
                d.get("text", "") if isinstance(d, dict) else str(d))
            if n == b"ECHO" else None)
        try:
            time.sleep(0.2)
            for _ in range(n_nodes):
                node = SimNode(event_port=wev, stream_port=wst, nmax=nmax,
                               device="cpu")
                t = threading.Thread(target=node.run, daemon=True)
                t.start()
                self.nodes.append(node)
                self.threads.append(t)
            self.client.connect(event_port=ev, stream_port=st, timeout=5.0)
            assert self.wait(lambda: len(self.client.nodes) >= n_nodes), \
                "workers never registered"
        except BaseException:
            self.close()
            raise

    def wait(self, cond, timeout=30.0):
        return wait_for(lambda: (self.client.receive(10), cond())[1],
                        timeout=timeout)

    def close(self):
        for n in self.nodes:
            n.quit()
        for t in self.threads:
            t.join(timeout=10)
        self.server.stop()
        self.server.join(timeout=5)
        self.client.close()


@pytest.fixture
def fabric():
    f = Fabric()
    try:
        yield f
    finally:
        f.close()


def test_simnode_is_torch_on_the_cpu(fabric):
    node = fabric.nodes[0]
    assert type(node).__name__ == "SimNode"
    assert node.sim.traf.state.device.type == "cpu"
    assert node.sim.node is node and node.sim.scr.node is node
    assert node.sim.areas.scr is node.sim.scr


def test_stackcmd_echo_and_acdata(fabric):
    acdata = []
    fabric.client.stream_received.connect(
        lambda n, d, s: acdata.append(d) if n == b"ACDATA" else None)
    fabric.client.subscribe(b"ACDATA")
    time.sleep(0.3)
    fabric.client.stack("CRE KL204 B744 52 4 90 FL200 250")
    fabric.client.stack("POS KL204")
    assert fabric.wait(lambda: any("KL204" in e for e in fabric.echoes))
    fabric.client.stack("OP")
    assert fabric.wait(lambda: any(f["id"] for f in acdata))
    frame = next(f for f in reversed(acdata) if f["id"])
    assert frame["id"] == ["KL204"] and frame["actype"] == ["B744"]
    assert isinstance(frame["lat"], np.ndarray)
    assert frame["lat"].dtype == np.float32 and frame["lat"].shape == (1,)
    assert abs(frame["lat"][0] - 52.0) < 0.5
    assert abs(frame["alt"][0] - 20000 * 0.3048) < 1.0
    assert frame["inconf"].dtype == bool and not frame["inconf"][0]
    assert frame["nconf_cur"] == 0


def test_getsimstate(fabric):
    states = []
    fabric.client.event_received.connect(
        lambda n, d, s: states.append(d) if n == b"SIMSTATE" else None)
    fabric.client.send_event(b"GETSIMSTATE")
    assert fabric.wait(lambda: len(states) > 0)
    assert states[0]["ntraf"] == 0 and states[0]["simt"] == 0.0
    assert states[0]["simdt"] == 0.05


def test_step_lockstep_advances_dtmult(fabric):
    """STEP advances ``dtmult`` seconds of sim time, pauses and acks to
    the sender."""
    acks = []
    fabric.client.event_received.connect(
        lambda n, d, s: acks.append(d) if n == b"STEP" else None)
    node = fabric.nodes[0]
    fabric.client.stack("CRE KL1 B744 52 4 90 FL200 250")
    fabric.client.stack("HOLD")
    assert fabric.wait(lambda: node.sim.traf.ntraf == 1
                       and node.sim.state_flag == HOLD)
    t0 = node.sim.simt_planned
    fabric.client.send_event(b"STEP")
    assert fabric.wait(lambda: len(acks) == 1)
    assert node.sim.simt_planned == pytest.approx(t0 + 1.0, abs=1e-6)
    assert node.sim.state_flag == HOLD


def test_step_clock_matches_jax(monkeypatch):
    """The STEP handler's clock, event by event, under DTMULT 1 and 2,
    is JAX's bit for bit (float32 clocks: where the clock falls just
    short of a step's target, both packages run one more 0.05 s step).
    The ack is dropped: a detached node loops it back into its own
    handler."""
    import jax.numpy  # noqa: F401
    from bluesky_tpu.simulation.simnode import DetachedSimNode as JNode
    no_pacing(monkeypatch)
    seqs = []
    for node in (JNode(nmax=16), DetachedSimNode(nmax=16, device="cpu")):
        node.send_event = lambda *a, **k: None
        for cmd in ("CRE KL1 B744 52 4 90 FL200 250", "HOLD"):
            node.sim.stack.stack(cmd)
        node.sim.stack.process()
        seq = [node.sim.simt_planned]
        for dtmult in (1, 1, 2, 2):
            node.sim.stack.stack(f"DTMULT {dtmult}")
            node.sim.stack.process()
            node.event(b"STEP", None, [])
            seq.append((node.sim.simt_planned, node.sim._step_count,
                        node.sim.state_flag))
        seqs.append(seq)
    assert seqs[1] == seqs[0]
    assert seqs[1][1][0] == pytest.approx(1.0, abs=1e-6)


def test_batch_farms_out_to_two_workers(tmp_path):
    scn = tmp_path / "mc.scn"
    scn.write_text(
        "00:00:00.00>SCEN CASE_A\n"
        "00:00:00.00>CRE AAA1 B744 52 4 90 FL200 250\n"
        "00:00:00.00>SCEN CASE_B\n"
        "00:00:00.00>CRE BBB1 B744 53 5 90 FL300 250\n")
    f = Fabric(n_nodes=2)
    try:
        f.client.stack(f"BATCH {scn}")

        def pieces_assigned():
            ids = [set(i for i in n.sim.traf.ids if i) for n in f.nodes]
            return ids[0] | ids[1] == {"AAA1", "BBB1"} \
                and len(ids[0]) == len(ids[1]) == 1
        assert f.wait(pieces_assigned, timeout=60)
        assert all(n.sim.state_flag == OP for n in f.nodes)
        assert {n.sim.stack.scenname for n in f.nodes} \
            == {"CASE_A", "CASE_B"}
        # the worker's REGISTER payload keys its piece as JAX's journal
        for n in f.nodes:
            inflight = n.register_payload()["inflight"]
            assert inflight["key"] == BatchJournal.piece_key(n._batch_piece)
    finally:
        f.close()


def test_worlds_pack_gives_one_batchworld_per_piece(tmp_path):
    """Four compatible pieces pack onto the one torch worker as a
    ``WorldBatch``; each completes once in the server's journal."""
    scn = tmp_path / "mc.scn"
    with open(scn, "w") as fh:
        for i in range(4):
            fh.write(f"00:00:00.00>SCEN CASE_{i}\n"
                     f"00:00:00.00>CRE CASE_{i}1 B744 {50 + i} 4 90 "
                     "FL200 250\n00:00:00.00>FF 3\n")
    f = Fabric(tmp_path, world_pack=True, world_batch_max=8)
    try:
        f.client.stack(f"BATCH {scn}")
        assert f.wait(lambda: f.server.packed_pieces == 4
                      and not f.server.inflight
                      and not f.server.scenarios, timeout=90)
        assert f.server.world_batches == 1
        assert f.server.worlds_payload()["demux_events"] >= 4
        state = BatchJournal.replay(f.journal)
        assert len(state["completed"]) == 4 and not state["pending"]
        assert f.wait(lambda: f.nodes[0].worlds is None)
    finally:
        f.close()


@pytest.fixture(scope="module")
def reply_fabric():
    f = Fabric()
    try:
        yield f
    finally:
        f.close()


#: command -> (what the worker itself echoes at once, the server payload
#: whose ``text`` the worker echoes when the reply arrives, or a marker
#: of that text)
REPLIES = {
    "HEALTH": ("HEALTH requested from the server", "queue: "),
    "METRICS DUMP": ("(server+fleet registries requested", "== server =="),
    "TRACE DUMP": ("TRACE DUMP", "server trace: recorder disabled"),
    "HA": ("HA status requested from the server", "ha_payload"),
    "MITIGATE": ("MITIGATE status requested from the server",
                 "mitigator"),
    "SDC": ("SDC status requested from the server", "sdc_payload"),
    "WORLDS": ("WORLDS requested from the server", "worlds_payload"),
    "ADDNODES 2": ("ADDNODES 2 requested from the server", None),
}


@pytest.mark.parametrize("cmd", sorted(REPLIES))
def test_server_reply_echoed(reply_fabric, cmd):
    f = reply_fabric
    local, remote = REPLIES[cmd]
    n0 = len(f.echoes)
    f.client.stack(cmd)
    assert f.wait(lambda: any(local in e for e in f.echoes[n0:])), \
        f.echoes[n0:]
    if remote is None:
        return
    if remote == "mitigator":
        want = f.server.mitigator.payload()["text"]
    elif remote.endswith("_payload"):
        want = getattr(f.server, remote)()["text"]
    else:
        want = remote
    assert f.wait(lambda: any(want in e for e in f.echoes[n0:])), \
        (want, f.echoes[n0:])


def test_worlds_and_mitigate_settings_reach_the_server(reply_fabric,
                                                      monkeypatch):
    f = reply_fabric
    for key in ("world_pack", "world_batch_max", "mitigate_enabled",
                "sdc_enabled", "sdc_audit_rate"):
        monkeypatch.setattr(tsettings, key, getattr(tsettings, key))
    pack0, max0 = f.server.world_pack, f.server.world_batch_max
    try:
        f.client.stack("WORLDS MAX 3")
        assert f.wait(lambda: f.server.world_batch_max == 3)
        f.client.stack("SDC AUDIT 0.25")
        assert f.wait(lambda: f.server.sdc_audit_rate == 0.25)
    finally:
        f.client.stack(f"WORLDS MAX {max0}")
        f.client.stack("SDC AUDIT 0")
        assert f.wait(lambda: f.server.world_batch_max == max0
                      and f.server.sdc_audit_rate == 0.0)
    assert f.server.world_pack == pack0


def test_opt_batch_piece_journal(tmp_path):
    """An OPT BATCH piece run by a torch worker: the server journals
    ``opt_result`` before the piece's ``completed`` record, and the
    client gets the BATCHOPT report."""
    lines = ["00:00:00.00>SCEN OPTCASE",
             "00:00:00.00>CRE OA00 B744 48.0 3.5 90 FL200 250",
             "00:00:00.00>CRE OB00 B744 48.0 4.5 270 FL200 250",
             "00:00:00.00>ADDWPT OA00 48.0,4.5",
             "00:00:00.00>ADDWPT OB00 48.0,3.5",
             "00:00:00.00>OPT 40,3"]
    scn = tmp_path / "opt.scn"
    scn.write_text("\n".join(lines) + "\n")
    f = Fabric(tmp_path, nmax=8)
    try:
        f.client.stack(f"BATCH {scn}")
        assert f.wait(lambda: f.server.opt_results >= 1
                      and not f.server.inflight
                      and not f.server.scenarios, timeout=150), \
            "OPT piece never completed"
        assert f.wait(lambda: bool(f.client.opt_results))
        rep = f.client.opt_results[0]
        assert rep["iters"] == 3 and rep["bad"] == -1
        recs = [json.loads(ln) for ln in open(f.journal)]
        kinds = [r["rec"] for r in recs]
        assert kinds.index("opt_result") < kinds.index("completed")
        state = BatchJournal.replay(f.journal)
        assert len(state["completed"]) == 1 and not state["pending"]
        assert state["opt_results"][0]["result"]["iters"] == 3
    finally:
        f.close()


def test_preempt_signal_checkpoints_and_exits(tmp_path, monkeypatch):
    """``on_preempt_signal`` on a networked worker: the chunk drains, a
    checkpoint named by the node id is written, the server gets
    PREEMPTED with its path, and the loop exits."""
    from bluesky_tpu_torch.simulation import snapshot
    from bluesky_tpu_torch.simulation.sim import Simulation
    monkeypatch.setattr(tsettings, "preempt_snapshot_dir", str(tmp_path))
    f = Fabric()
    echoes = f.echoes
    node, thread = f.nodes[0], f.threads[0]
    try:
        f.client.stack("CRE KL0 B744 52 4 90 FL200 250",
                       target=node.node_id)
        assert f.wait(lambda: node.sim.traf.ntraf == 1)
        node.on_preempt_signal(15)
        thread.join(timeout=60)
        assert not thread.is_alive(), "node never exited"
        assert f.wait(lambda: node.node_id not in f.server.workers)
        path = os.path.join(str(tmp_path),
                            f"preempt-{node.node_id.hex()[:8]}.snap")
        assert os.path.isfile(path)
        other = Simulation(nmax=16, device="cpu")
        ok, msg = snapshot.load(other, path)
        assert ok, msg
        assert other.traf.ntraf == 1 and other.traf.ids[0] == "KL0"
        assert f.wait(lambda: any("preempted" in e for e in echoes)), echoes
    finally:
        f.close()


# ------------------------------------------------------- slice parity
PARITY_CMDS = ("SYN SUPER 8", "ASAS ON", "OP")
ACDATA_KEYS = ("id", "actype", "lat", "lon", "alt", "trk", "tas", "gs",
               "cas", "vs", "inconf", "tcpamax", "asasn", "asase",
               "nconf_cur", "nconf_tot", "nlos_cur", "nlos_tot",
               "traillastlat", "traillastlon")


def _frame(node):
    node.streams.clear()
    node.sim.scr.send_aircraft_data()
    (name, data), = node.streams
    assert name == b"ACDATA"
    return data


def _hold_frames(jf, tf):
    assert tf["simt"] == pytest.approx(jf["simt"], abs=1e-12)
    for k in ACDATA_KEYS:
        want, got = jf[k], tf[k]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, k
            if want.dtype == bool:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                rtol = SIM_CMD_RTOL if k in ("asasn", "asase", "tcpamax",
                                             "vs") else SIM_RTOL
                np.testing.assert_allclose(got, want, rtol=rtol,
                                           atol=SIM_ATOL, err_msg=k)
        else:
            assert got == want, k


def test_slice_parity_detached_acdata(monkeypatch):
    """The same STACKCMD events into JAX's ``DetachedSimNode`` and the
    port's (float64, dense): the ACDATA frames agree after the command
    (the live-state path) and after every one of ten 1 s chunks (the
    chunk edge's pack), the fleet in conflict by the end."""
    import jax.numpy as jnp
    import torch
    from bluesky_tpu.simulation.simnode import DetachedSimNode as JNode
    no_pacing(monkeypatch)
    jnode = JNode(nmax=32, dtype=jnp.float64)
    tnode = DetachedSimNode(nmax=32, dtype=torch.float64, device="cpu")
    for node in (jnode, tnode):
        for cmd in PARITY_CMDS:
            node.event(b"STACKCMD", {"cmd": cmd}, [])
        node.sim.stack.process()
    _hold_frames(_frame(jnode), _frame(tnode))
    assert tnode.sim._last_edge is None       # the live-state path
    for _ in range(10):
        for node in (jnode, tnode):
            node.step()
            node.sim.drain_pipeline()
        assert tnode.sim._last_edge is not None
        _hold_frames(_frame(jnode), _frame(tnode))
    assert tnode.sim.simt == pytest.approx(10.0, abs=1e-9)
    assert _frame(tnode)["nconf_cur"] > 0


def test_detached_simnode_answers_locally():
    """A detached worker's server-bound events loop back into its own
    handler, and its streams buffer in ``node.streams``."""
    node = DetachedSimNode(nmax=16, device="cpu")
    assert node.sim.traf.state.device.type == "cpu"
    node.event(b"STACKCMD", {"cmd": "HEALTH"}, [])
    node.sim.stack.process()
    assert any(e.startswith("detached sim: state")
               for e in node.sim.scr.echobuf)
    node.event(b"GETSIMSTATE", None, [])
    node.sim.stack.stack("CRE AB1 B744 52 4 90 FL100 200")
    node.sim.stack.process()
    node.sim.op()
    for _ in range(3):
        node.step()
    assert node.sim.traf.ntraf == 1 and node.sim.simt > 0.0
    assert node.register_payload() is None
    hb = node.heartbeat_payload(7)
    assert hb["stamp"] == 7 and hb["ntraf"] == 1 and hb["state"] == OP
    node.event(b"QUIT", None, [])
    assert not node.running and node.sim.state_flag == 3


def test_piece_key_is_jax_journal_key():
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(1, 6))
        piece = (rng.uniform(0, 100, n).round(2).tolist(),
                 [f"CRE A{int(i)} B744 52 4 90 FL200 250"
                  for i in rng.integers(0, 999, n)])
        assert piece_key(piece) == BatchJournal.piece_key(piece)
