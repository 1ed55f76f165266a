"""The port's server side (``bluesky_tpu_torch.network.server`` and
``client``) on the CPU, alone and against the JAX package's.

* A torch ``Server(headless=True, spawn_workers=False)`` with torch
  ``SimNode(device="cpu")`` threads and the torch ``Client``: REGISTER,
  echo and NODESCHANGED (JAX's ``tests/test_network.py``), BATCH farmed
  to two workers (``tests/test_batch.py``), a WORLDS pack.
* Across the packages: a JAX ``Client`` on a torch server, and a JAX
  ``SimNode`` behind a torch server, each for one echo and one BATCH
  piece.
* Held against JAX's server: one scripted run of protocol-level fake
  workers (register, take a piece, report HOLD, die, go silent) on each
  package's server gives the same journal records (``rec`` and ``key``,
  in order) and the same HEALTH text with the numbers and ids masked;
  a seeded set of SDC fingerprints gives the same suspect, vote and
  quarantine records, byte for byte.
* Spawned torch workers (``python -m bluesky_tpu_torch --sim`` with the
  server's config file, ``device = 'cpu'``): a killed worker's piece is
  requeued and the batch completes (JAX's
  ``tests/test_fabric_hardening.py``); a killed server resumes with
  ``--resume-batch`` and completes every piece exactly once.
* Resuming across the packages: a journal written by JAX's server is
  resumed by the port's, and the reverse, exactly once.

Every wait is bounded; servers, nodes, clients and spawned processes
are stopped in ``finally``.
"""
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time

import pytest

zmq = pytest.importorskip("zmq")

from bluesky_tpu.network.client import Client as JClient
from bluesky_tpu.network.journal import BatchJournal as JJournal
from bluesky_tpu.network.npcodec import packb
from bluesky_tpu.network.server import Server as JServer
from bluesky_tpu_torch import settings as tsettings
from bluesky_tpu_torch.network.client import Client as TClient
from bluesky_tpu_torch.network.journal import BatchJournal as TJournal
from bluesky_tpu_torch.network.server import Server as TServer
from bluesky_tpu_torch.simulation.simnode import SimNode as TSimNode
from tests.test_network import free_ports, wait_for
from tests.test_overload import FakeWorker, _batch

from torch_parity import no_pacing  # (and torch at one thread)

OP, HOLD = 2, 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torch_node(wev, wst):
    return TSimNode(event_port=wev, stream_port=wst, nmax=16,
                    device="cpu")


class Fabric:
    """A server, ``n`` sim-node threads and a client of the given
    classes, started; ``close`` stops all of them."""

    def __init__(self, tmp_path=None, n_nodes=1, server_cls=TServer,
                 client_cls=TClient, make_node=_torch_node, **serverkw):
        ev, st, wev, wst = free_ports(4)
        self.ports = (ev, st, wev, wst)
        self.journal = str(tmp_path / "batch.jsonl") \
            if tmp_path is not None else ""
        serverkw.setdefault("journal_path", self.journal)
        self.server = server_cls(headless=True, spawn_workers=False,
                                 ports=dict(event=ev, stream=st,
                                            wevent=wev, wstream=wst),
                                 **serverkw)
        self.server.start()
        self.make_node = make_node
        self.nodes, self.threads = [], []
        self.client = client_cls()
        self.echoes = []
        self.client.event_received.connect(
            lambda n, d, s: self.echoes.append(
                d.get("text", "") if isinstance(d, dict) else str(d))
            if n == b"ECHO" else None)
        try:
            time.sleep(0.2)
            self.add_nodes(n_nodes)
            self.client.connect(event_port=ev, stream_port=st, timeout=5.0)
            assert self.wait(lambda: len(self.client.nodes) >= n_nodes), \
                "workers never registered"
        except BaseException:
            self.close()
            raise

    def add_nodes(self, n):
        for _ in range(n):
            node = self.make_node(*self.ports[2:])
            t = threading.Thread(target=node.run, daemon=True)
            t.start()
            self.nodes.append(node)
            self.threads.append(t)

    def wait(self, cond, timeout=30.0):
        return wait_for(lambda: (self.client.receive(10), cond())[1],
                        timeout=timeout)

    def batch_done(self, timeout=60.0):
        return self.wait(lambda: not self.server.inflight
                         and not self.server.scenarios, timeout=timeout)

    def close(self):
        for n in self.nodes:
            n.quit()
        for t in self.threads:
            t.join(timeout=10)
        self.server.stop()
        self.server.join(timeout=5)
        self.client.close()
        assert not self.server.is_alive()


def _scn(tmp_path, pieces, name="mc.scn"):
    """A scenario file of ``pieces`` ``(name, [lines])`` SCEN blocks,
    every line at 00:00:00."""
    path = tmp_path / name
    with open(path, "w") as f:
        for tag, lines in pieces:
            f.write(f"00:00:00.00>SCEN {tag}\n")
            for ln in lines:
                f.write(f"00:00:00.00>{ln}\n")
    return path


def _completed(jpath, cls=TJournal):
    return cls.replay(jpath)["completed"] if os.path.isfile(jpath) else []


def _records(jpath):
    out = []
    if not os.path.isfile(jpath):
        return out
    for line in open(jpath, encoding="utf-8"):
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


# ------------------------------------------------------ the torch fabric
def test_register_echo_and_nodeschanged(monkeypatch):
    no_pacing(monkeypatch)
    f = Fabric()
    try:
        assert f.client.host_id == f.server.server_id
        assert set(f.client.nodes) == {f.nodes[0].node_id}
        assert f.wait(lambda: f.nodes[0].host_id == f.server.server_id)
        f.client.stack("ECHO hello from the port")
        assert f.wait(lambda: "hello from the port" in f.echoes)
        f.add_nodes(1)                       # NODESCHANGED reaches us
        assert f.wait(lambda: set(f.client.nodes)
                      == {n.node_id for n in f.nodes})
        assert set(f.server.workers) == {n.node_id for n in f.nodes}
        f.nodes[1].quit()
        f.threads[1].join(timeout=10)
        assert f.wait(lambda: set(f.client.nodes) == {f.nodes[0].node_id})
    finally:
        f.close()


def test_batch_farms_out_to_two_workers(tmp_path, monkeypatch):
    no_pacing(monkeypatch)
    scn = _scn(tmp_path, [("CASE_A", ["CRE AAA1 B744 52 4 90 FL200 250"]),
                          ("CASE_B", ["CRE BBB1 B744 53 5 90 FL300 250"])])
    f = Fabric(tmp_path, n_nodes=2)
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
        assert len(f.server.inflight) == 2
        recs = [r["rec"] for r in _records(f.journal)]
        assert recs == ["queued", "queued", "dispatched", "dispatched"]
    finally:
        f.close()


def test_worlds_pack_completes_each_piece_once(tmp_path, monkeypatch):
    no_pacing(monkeypatch)
    scn = _scn(tmp_path, [(f"CASE_{i}", [f"CRE C{i} B744 {50 + i} 4 90 "
                                         "FL200 250", "FF 3"])
                          for i in range(4)])
    f = Fabric(tmp_path, world_pack=True, world_batch_max=8)
    try:
        f.client.stack(f"BATCH {scn}")
        assert f.wait(lambda: f.server.packed_pieces == 4
                      and not f.server.inflight
                      and not f.server.scenarios, timeout=90)
        assert f.server.world_batches == 1
        assert f.server.worlds_payload()["demux_events"] >= 4
        state = TJournal.replay(f.journal)
        assert len(state["completed"]) == 4 and not state["pending"]
        assert _records(f.journal) and all(
            r.get("pack") == 4 for r in _records(f.journal)
            if r["rec"] == "dispatched")
    finally:
        f.close()


# ------------------------------------------------------ across packages
def _one_piece(tmp_path, tag):
    return _scn(tmp_path, [(tag, ["CRE PCE1 B744 52 4 90 FL200 250",
                                  "HOLD"])], name=f"{tag}.scn")


def test_jax_client_on_the_torch_server(tmp_path, monkeypatch):
    no_pacing(monkeypatch)
    f = Fabric(tmp_path, client_cls=JClient)
    try:
        assert f.client.host_id == f.server.server_id
        f.client.stack("ECHO jax client")
        assert f.wait(lambda: "jax client" in f.echoes)
        f.client.stack(f"BATCH {_one_piece(tmp_path, 'XJC')}")
        assert f.wait(lambda: len(_completed(f.journal)) == 1)
        assert f.batch_done()
        f.client.request_health()
        assert f.wait(lambda: f.client.last_health is not None)
        assert f.nodes[0].node_id.hex() in f.client.last_health["workers"]
    finally:
        f.close()


def test_jax_simnode_behind_the_torch_server(tmp_path):
    from bluesky_tpu.simulation.simnode import SimNode as JSimNode
    f = Fabric(tmp_path, make_node=lambda wev, wst: JSimNode(
        event_port=wev, stream_port=wst, nmax=16))
    try:
        f.client.stack("ECHO jax node")
        assert f.wait(lambda: "jax node" in f.echoes)
        f.client.stack(f"BATCH {_one_piece(tmp_path, 'XJN')}")
        assert f.wait(lambda: len(_completed(f.journal)) == 1, timeout=90)
        assert f.batch_done()
        assert f.nodes[0].sim.stack.scenname == "XJN"
    finally:
        f.close()


# ----------------------------------------------- held against JAX's server
def _mask(text):
    """HEALTH text without its numbers, worker ids and journal path."""
    text = re.sub(r"\b[0-9a-f]{8,10}\b", "<id>", text)
    text = re.sub(r"\S*batch\.jsonl", "<journal>", text)
    return re.sub(r"\d+(\.\d+)?", "#", text)


def _scripted(server_cls, tmp_path):
    """One scripted run of fake workers on ``server_cls``: returns the
    journal's ``(rec, key)`` sequence and the masked HEALTH text."""
    jpath = str(tmp_path / server_cls.__module__.split(".")[0]
                / "batch.jsonl")
    ev, st, wev, wst = free_ports(4)
    server = server_cls(headless=True, spawn_workers=False,
                        ports=dict(event=ev, stream=st, wevent=wev,
                                   wstream=wst),
                        journal_path=jpath, hb_interval=0.1,
                        hb_timeout=1.0, batch_queue_max=3)
    server.start()
    client = JClient()
    workers = []
    try:
        time.sleep(0.2)
        client.connect(event_port=ev, stream_port=st, timeout=5.0)
        w1 = FakeWorker(wev)
        workers.append(w1)
        assert wait_for(lambda: w1.id in server.workers, timeout=10)
        client.send_event(b"BATCH", _batch(3, "S"), target=b"")
        # over the admission limit: rejected, nothing journaled
        client.send_event(b"BATCH", _batch(2, "R"), target=b"")
        assert wait_for(lambda: (client.receive(10),
                                 client.last_rejection is not None)[1],
                        timeout=10)
        assert wait_for(lambda: w1.id in server.inflight, timeout=10)
        w1.statechange(OP)
        w1.statechange(HOLD)                       # S0 completes
        assert wait_for(lambda: len(w1.received(b"BATCH")) == 2,
                        timeout=10)                # S1 goes to w1
        w2 = FakeWorker(wev)
        workers.append(w2)
        assert wait_for(lambda: w2.id in server.inflight, timeout=10)
        w1.statechange(-1)                         # w1 dies with S1
        assert wait_for(lambda: w1.id not in server.workers, timeout=10)
        w2.statechange(OP)
        w2.statechange(HOLD)                       # S2 completes
        assert wait_for(lambda: len(w2.received(b"BATCH")) == 2,
                        timeout=10)                # the requeued S1
        w3 = FakeWorker(wev)                       # registers, then
        workers.append(w3)                         # goes silent
        assert wait_for(lambda: w3.id in server.workers, timeout=10)
        assert wait_for(lambda: w3.id not in server.workers, timeout=10)
        w2.statechange(OP)
        w2.statechange(HOLD)                       # S1 completes
        assert wait_for(lambda: not server.inflight
                        and not server.scenarios, timeout=10)
        client.request_health()
        assert wait_for(lambda: (client.receive(10),
                                 client.last_health is not None)[1],
                        timeout=10)
        text = client.last_health["text"]
    finally:
        for w in workers:
            w.close()
        client.close()
        server.stop()
        server.join(timeout=5)
    return [(r["rec"], r.get("key")) for r in _records(jpath)], \
        _mask(text)


def test_scripted_run_matches_jax_server(tmp_path, capsys):
    jrecs, jtext = _scripted(JServer, tmp_path)
    trecs, ttext = _scripted(TServer, tmp_path)
    capsys.readouterr()
    assert trecs == jrecs
    assert ttext == jtext
    kinds = [r for r, _ in trecs]
    assert kinds.count("completed") == 3 and kinds.count("queued") == 3
    assert "crashed" in kinds and kinds[-1] == "shutdown"


def _wid(i):
    return bytes([0, 0x5d, 0, 0, i])


def _sdc_run(server_cls, path, seed):
    s = server_cls(headless=True, spawn_workers=False,
                   journal_path=str(path), sdc_enabled=True,
                   mitigate_enabled=True)
    rng = random.Random(seed)
    try:
        for i in range(8):
            s.workers[_wid(i)] = 0
            s.last_seen[_wid(i)] = time.monotonic()
        for i in range(12):
            p = ([0.0], [f"SCEN SD{i}"])
            a, b, c = (_wid(w) for w in rng.sample(range(8), 3))
            words = [f"{rng.randint(0, 3):08x}" for _ in range(3)]
            if c not in s.avail_workers and c not in s.inflight \
                    and c not in s.sdc_quarantine:
                s.avail_workers.append(c)
            s._note_sdc_fp(a, p, {"fp": words[0]})
            s._note_sdc_fp(b, p, {"fp": words[1]})
            s._sdc_compare(p, via=rng.choice(["hedge_dup", "audit"]))
            if c in s._sdc_execs:
                # the tie-break copy completes on c
                s._note_sdc_fp(c, p, {"fp": words[2]})
                s._handle_server_event(s.be_event, c, b"STATECHANGE",
                                       packb(HOLD))
        return (s.sdc_suspects, s.sdc_votes, s.sdc_quarantined_workers,
                sorted(w.hex() for w in s.sdc_quarantine),
                {k: v for k, v in s.sdc_payload().items()
                 if k != "text"})
    finally:
        for sock in (s.fe_event, s.fe_stream, s.be_event, s.be_stream):
            sock.close()
        if s.journal:
            s.journal.close()


@pytest.mark.parametrize("seed", [1, 2])
def test_sdc_records_match_jax(tmp_path, seed, capsys):
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    jres = _sdc_run(JServer, jpath, seed)
    tres = _sdc_run(TServer, tpath, seed)
    capsys.readouterr()
    assert tres == jres
    assert tpath.read_bytes() == jpath.read_bytes()
    kinds = {r["rec"] for r in _records(str(tpath))}
    assert {"sdc_suspect", "sdc_vote", "mitigation"} <= kinds
    assert jres[0] > 0 and jres[1] > 0


# ------------------------------------------------------ spawned workers
def _cpu_cfg(tmp_path, ports, **extra):
    """A config file for a CPU fabric on the given free ports."""
    ev, st, wev, wst, disc = ports
    keys = dict(device="cpu", telnet_port=0, event_port=ev, stream_port=st,
                wevent_port=wev, wstream_port=wst, discovery_port=disc,
                log_path=str(tmp_path / "log"), **extra)
    path = tmp_path / "cpu.cfg"
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return str(path)


def _env():
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_spawned_worker_killed_piece_requeued(tmp_path, monkeypatch):
    """kill -9 a spawned torch worker while its piece is in flight: the
    server buries it, requeues the piece, spawns a replacement (with the
    server's config file: a CPU worker) and the batch completes."""
    ports = free_ports(5)
    monkeypatch.setattr(tsettings, "config_file", _cpu_cfg(tmp_path, ports))
    # real time (no FF): the first piece stays in flight for 3 s
    scn = tmp_path / "mc.scn"
    scn.write_text(
        "00:00:00.00>SCEN CASE_A\n"
        "00:00:00.00>CRE AAA1 B744 52 4 90 FL200 250\n"
        "00:00:03.00>HOLD\n"
        "00:00:00.00>SCEN CASE_B\n"
        "00:00:00.00>CRE BBB1 B744 53 5 90 FL300 250\n"
        "00:00:01.00>HOLD\n")
    jpath = str(tmp_path / "batch.jsonl")
    server = TServer(headless=True, ports=dict(zip(
        ("event", "stream", "wevent", "wstream"), ports)),
        spawn_workers=True, max_nnodes=1, hb_interval=0.5,
        journal_path=jpath)
    server.start()
    client = TClient()
    try:
        time.sleep(0.2)
        client.connect(event_port=ports[0], stream_port=ports[1],
                       timeout=5.0)
        server.addnodes(1)
        assert wait_for(lambda: (client.receive(10),
                                 len(server.workers) == 1)[1],
                        timeout=120), "spawned worker never registered"
        (first,) = list(server.spawned.values())
        assert "--config-file" in first.args
        client.stack(f"BATCH {scn}")
        assert wait_for(lambda: (client.receive(10),
                                 bool(server.inflight))[1], timeout=60)
        (wid, piece), = list(server.inflight.items())
        os.kill(server.spawned[wid].pid, signal.SIGKILL)
        assert wait_for(lambda: wid not in server.workers, timeout=15), \
            "dead worker never reaped"
        assert wait_for(lambda: (client.receive(10),
                                 len(server.workers) == 1
                                 and wid not in server.workers)[1],
                        timeout=120), "replacement worker never came up"
        assert wait_for(lambda: (client.receive(10),
                                 not server.scenarios
                                 and not server.inflight)[1],
                        timeout=120), "batch did not complete after crash"
        state = TJournal.replay(jpath)
        assert len(state["completed"]) == 2 and not state["pending"]
        recs = [r["rec"] for r in _records(jpath)]
        assert recs.count("crashed") == 1 and recs.count("completed") == 2
    finally:
        server.stop()
        server.join(timeout=15)
        client.close()
        for proc in server.processes:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    assert all(p.poll() is not None for p in server.processes)


def _start_cli_server(cfg, log, *extra):
    """``python -m bluesky_tpu_torch --config-file cfg`` (the default
    mode: the server) in its own process group, output to ``log``."""
    return subprocess.Popen(
        [sys.executable, "-m", "bluesky_tpu_torch", "--config-file", cfg,
         *extra], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        env=_env(), start_new_session=True)


def _kill_group(proc, sig=signal.SIGKILL):
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except (ProcessLookupError, PermissionError):
        proc.kill()
    proc.wait(timeout=30)


def test_killed_server_resumes_batch_exactly_once(tmp_path):
    """kill -9 the server process group (server and spawned worker)
    mid-BATCH; ``--resume-batch`` on a new server: the completed piece
    is not re-run, the in-flight one is, each completes exactly once."""
    scn = tmp_path / "sweep.scn"
    scn.write_text(
        "00:00:00.00>SCEN CASE_A\n"
        "00:00:00.00>CRE AAA1 B744 52 4 90 FL200 250\n"
        "00:00:00.50>HOLD\n"
        "00:00:00.00>SCEN CASE_B\n"
        "00:00:00.00>CRE BBB1 B744 53 5 90 FL300 250\n"
        "00:00:02.00>HOLD\n")
    ports = free_ports(5)
    cfg = _cpu_cfg(tmp_path, ports, max_nnodes=1,
                   batch_journal_fsync=False)
    log = open(tmp_path / "server.log", "w")
    srv = _start_cli_server(cfg, log, "--headless")
    srv2 = None
    client = TClient()
    try:
        client.connect(event_port=ports[0], stream_port=ports[1],
                       timeout=30.0)
        assert wait_for(lambda: (client.receive(10),
                                 len(client.nodes) == 1)[1], timeout=120)
        client.stack(f"BATCH {scn}")

        def one_done_one_inflight():
            client.receive(10)
            recs = _records(jpath)
            done = {r["key"] for r in recs if r["rec"] == "completed"}
            disp = [r for r in recs if r["rec"] == "dispatched"
                    and r["key"] not in done]
            return len(done) == 1 and len(disp) == 1
        # the CLI server journals under log_path as batch-<id>.jsonl
        logdir = tmp_path / "log"
        assert wait_for(lambda: logdir.is_dir() and any(
            p.suffix == ".jsonl" for p in logdir.iterdir()), timeout=60)
        (jpath,) = [str(p) for p in logdir.iterdir()
                    if p.suffix == ".jsonl"]
        assert wait_for(one_done_one_inflight, timeout=60), \
            f"never reached one-done-one-inflight: {_records(jpath)}"
        _kill_group(srv)
        st = TJournal.replay(jpath)
        assert len(st["completed"]) == 1 and len(st["pending"]) == 1
        srv2 = _start_cli_server(cfg, log, "--resume-batch", jpath)

        def sweep_complete():
            st = TJournal.replay(jpath)
            return not st["pending"] and len(st["completed"]) == 2
        assert wait_for(sweep_complete, timeout=120), \
            f"resumed sweep never completed: {_records(jpath)}"
        completed = [r["key"] for r in _records(jpath)
                     if r["rec"] == "completed"]
        assert len(completed) == 2 and len(set(completed)) == 2
        assert any(r["rec"] == "resumed" for r in _records(jpath))
        srv2.send_signal(signal.SIGTERM)
        assert srv2.wait(timeout=60) == 0
        assert _records(jpath)[-1]["rec"] == "shutdown"
    finally:
        client.close()
        for p in (srv, srv2):
            if p is not None and p.poll() is None:
                _kill_group(p)
        log.close()


# ------------------------------------ resuming across the two packages
def _left_journal(cls, jpath, pieces):
    """A journal as a crashed server left it: every piece queued, the
    first completed, the second in flight."""
    j = cls(str(jpath), fsync=False)
    j.queued_many(pieces)
    j.dispatched(pieces[0], b"\x00\x01\x02\x03\x04")
    j.completed(pieces[0], b"\x00\x01\x02\x03\x04")
    j.dispatched(pieces[1], b"\x00\x01\x02\x03\x04")
    j.close()


@pytest.mark.parametrize("writer,server_cls", [
    (JJournal, TServer), (TJournal, JServer)],
    ids=["jax_journal_torch_server", "torch_journal_jax_server"])
def test_resume_across_packages(tmp_path, writer, server_cls,
                                monkeypatch):
    """The decision pinned here: a journal written by either package's
    server resumes in the other's (the files are byte-identical, so
    nothing tells them apart), and the resumed sweep completes every
    piece exactly once, behind a torch worker."""
    no_pacing(monkeypatch)
    jpath = tmp_path / "batch.jsonl"
    # the HOLD a simulated second in: a piece that holds at once leaves
    # a worker that held before without a state change to report
    pieces = [([0.0, 0.0, 1.0], [f"SCEN R{i}",
                                 f"CRE R{i} B744 52 4 90 FL200 250",
                                 "HOLD"]) for i in range(3)]
    _left_journal(writer, jpath, pieces)
    f = Fabric(tmp_path, server_cls=server_cls,
               resume_journal=str(jpath), journal_path=str(jpath))
    try:
        assert f.wait(lambda: len(_completed(str(jpath))) == 3,
                      timeout=60)
        assert f.batch_done()
    finally:
        f.close()
    recs = _records(str(jpath))
    done = [r["key"] for r in recs if r["rec"] == "completed"]
    assert sorted(done) == sorted(TJournal.piece_key(p) for p in pieces)
    assert any(r["rec"] == "resumed" for r in recs)
    for cls in (JJournal, TJournal):
        st = cls.replay(str(jpath))
        assert not st["pending"] and len(st["completed"]) == 3
