"""Broker high availability in the port (``bluesky_tpu_torch.network.ha``
and the torch ``Server``'s HA roles) against the JAX package's, on the
CPU.

* Lease files written by one package are read by the other, with the
  same staleness, and the same torn or absent files read as none.
* ``JournalTail`` follows a journal written by the other package, torn
  tail held back, as JAX's does.
* ``reconcile`` and ``is_stale`` give JAX's results on seeded inputs.
* One leader-to-standby takeover with two torch servers on one journal
  (a case of JAX's ``tests/test_ha.py``): the leader journals a BATCH,
  dies with a piece in flight, the standby takes the lease at epoch 2,
  holds the owed piece through the adoption grace, requeues it to a new
  worker, and the sweep completes exactly once.
"""
import json
import os
import random
import time

import pytest

zmq = pytest.importorskip("zmq")

from bluesky_tpu.network import ha as jha
from bluesky_tpu.network.journal import BatchJournal as JJournal
from bluesky_tpu_torch.network import ha as tha
from bluesky_tpu_torch.network.client import Client
from bluesky_tpu_torch.network.journal import BatchJournal as TJournal
from bluesky_tpu_torch.network.server import Server
from tests.test_network import free_ports, wait_for
from tests.test_overload import FakeWorker, _batch


def _piece(tag):
    return ([0.0], [f"SCEN {tag}", "CRE A1 B744 52 4 90 FL200 250"])


@pytest.mark.parametrize("writer,reader", [(jha, tha), (tha, jha)])
def test_lease_files_cross_read(tmp_path, writer, reader):
    path = writer.lease_path(str(tmp_path / "batch.jsonl"))
    assert path == reader.lease_path(str(tmp_path / "batch.jsonl"))
    assert writer.write_lease(path, "ab01", 3, 2.5, stamp=1000.0)
    lease = reader.read_lease(path)
    assert lease == jha.read_lease(path) == tha.read_lease(path)
    assert lease == {"leader": "ab01", "epoch": 3, "ttl": 2.5,
                     "stamp": 1000.0}
    assert not os.path.exists(path + ".tmp")
    assert writer.write_lease(path, "cd02", 4, 60.0)
    assert not reader.is_stale(reader.read_lease(path))
    for body in ('{"leader": "ab", "ep', '{"leader": "ab"}', ""):
        with open(path, "w") as f:
            f.write(body)
        assert reader.read_lease(path) is None
    assert reader.read_lease(str(tmp_path / "absent.lease")) is None


def test_stale_and_reconcile_match_jax():
    rng = random.Random(5)
    for _ in range(200):
        lease = rng.choice([None, {"leader": "aa", "epoch": 1,
                                   "ttl": rng.choice([0.0, 0.5, 5.0]),
                                   "stamp": rng.uniform(0.0, 20.0)}])
        now, dflt = rng.uniform(0.0, 30.0), rng.choice([1.0, 10.0])
        assert tha.is_stale(lease, now, dflt) \
            == jha.is_stale(lease, now, dflt)
        if lease is not None:
            assert tha.lease_age(lease, now) == jha.lease_age(lease, now)
    pieces = [_piece(t) for t in "ABCDE"]
    for _ in range(50):
        pending = [rng.choice(pieces) for _ in range(rng.randint(0, 6))]
        reported = [(f"w{i}", rng.choice(
            [JJournal.piece_key(rng.choice(pieces)), "feedface"]))
            for i in range(rng.randint(0, 5))]
        assert tha.reconcile(pending, reported) \
            == jha.reconcile(pending, reported)


def test_journal_tail_follows_the_other_package(tmp_path):
    path = str(tmp_path / "batch.jsonl")
    jt, tt = jha.JournalTail(path), tha.JournalTail(path)
    assert jt.poll() == tt.poll() == 0
    j = JJournal(path, fsync=False)
    j.epoch = 1
    j.lease("aa", 1, ttl=1.0)
    j.queued_many([_piece("A"), _piece("B")])
    j.close()
    t = TJournal(path, fsync=False)
    t.epoch = 2
    t.lease("bb", 2, ttl=1.0)
    t.close()
    with open(path, "a") as f:
        f.write('{"rec":"lease","leader":"cc","ep')
    for tail in (jt, tt):
        assert tail.poll() == 4
        assert (tail.records, tail.leases, tail.epoch, tail.leader) \
            == (4, 2, 2, "bb")
    with open(path, "a") as f:
        f.write('och":3,"ttl":1}\n')
    assert jt.poll() == tt.poll() == 1
    assert jt.leader == tt.leader == "cc" and jt.epoch == tt.epoch == 3


def _records(jpath):
    out = []
    for line in open(jpath, encoding="utf-8"):
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def test_standby_takes_over_from_a_dead_leader(tmp_path):
    jpath = str(tmp_path / "batch.jsonl")
    kw = dict(headless=True, spawn_workers=False, journal_path=jpath,
              ha_lease_ttl=0.3, ha_poll_dt=0.05, hb_interval=0.1)
    ports = [dict(zip(("event", "stream", "wevent", "wstream"),
                      free_ports(4))) for _ in range(2)]
    leader = Server(ports=ports[0], ha_role="leader", **kw)
    standby = Server(ports=ports[1], ha_role="standby", **kw)
    client = Client()
    w1 = w2 = None
    try:
        leader.start()
        assert wait_for(lambda: os.path.exists(tha.lease_path(jpath)))
        standby.start()
        client.connect(event_port=ports[0]["event"],
                       stream_port=ports[0]["stream"], timeout=5.0)
        assert client.host_epoch == 1
        w1 = FakeWorker(ports[0]["wevent"])
        assert wait_for(lambda: w1.id in leader.workers, timeout=10)
        client.send_event(b"BATCH", _batch(2, "HA"), target=b"")
        assert wait_for(lambda: w1.id in leader.inflight, timeout=10)
        w1.statechange(2)
        w1.statechange(1)               # the first piece completes ...
        assert wait_for(lambda: len(w1.received(b"BATCH")) == 2,
                        timeout=10)     # ... and the second is in flight
        # the leader dies with the second piece in flight
        leader.stop()
        leader.join(timeout=5)
        w1.close()
        w1 = None
        # the standby sees the lease go stale and takes over at epoch 2
        # (its journaled ``resumed`` record follows the replay's fold)
        assert wait_for(lambda: any(r["rec"] == "resumed"
                                    and r.get("takeover")
                                    for r in _records(jpath)), timeout=10)
        assert standby.ha_role == "leader" and standby._ha_serving
        assert standby.ha_takeovers == 1 and standby.ha_epoch == 2
        # the owed piece waits in limbo for its adoption grace, then
        # queues (no worker has registered with the new leader yet)
        assert {p[1][0] for p in standby._ha_limbo} \
            | {p[1][0] for p in standby.scenarios} == {"SCEN HA1"}
        lease = tha.read_lease(tha.lease_path(jpath))
        assert lease["leader"] == standby.server_id.hex()
        assert jha.read_lease(tha.lease_path(jpath)) == lease
        # a new worker gets the owed piece after the adoption grace
        w2 = FakeWorker(ports[1]["wevent"])
        assert wait_for(lambda: w2.id in standby.inflight, timeout=15)
        w2.statechange(2)
        w2.statechange(1)
        assert wait_for(lambda: not standby.inflight
                        and not standby.scenarios, timeout=10)
        for fold in (TJournal.replay(jpath), JJournal.replay(jpath)):
            assert fold["pending"] == [] and len(fold["completed"]) == 2
            assert fold["ha"]["epoch"] == 2
        recs = _records(jpath)
        assert [r["epoch"] for r in recs if r["rec"] == "lease"] == [1, 2]
        assert any(r["rec"] == "resumed" and r.get("takeover")
                   for r in recs)
        assert len([r for r in recs if r["rec"] == "completed"]) == 2
    finally:
        for w in (w1, w2):
            if w is not None:
                w.close()
        client.close()
        for s in (leader, standby):
            s.stop()
            s.join(timeout=5)
        assert not leader.is_alive() and not standby.is_alive()
