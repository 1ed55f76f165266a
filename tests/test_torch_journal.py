"""The port's BATCH journal (``bluesky_tpu_torch.network.journal``)
against the JAX package's, on the CPU.

* The same seeded sequence of calls, every record type among them,
  writes byte-identical files with either package's ``BatchJournal``
  (the journal has no wall-clock field, so nothing is masked), HA
  ``wepoch`` stamping and a healed crash-torn tail included.
* Each package's ``replay`` folds the other's file to the same dict,
  with ``fence_strict`` on and off.
* Seeded cases of JAX's ``tests/test_journal_fuzz.py``, replayed by the
  port: exactly-once across torn and garbled lines, the deposed
  leader's fence, synthetic pieces.
* ``piece_key`` equals JAX's, and the worker's key is the journal's.
"""
import json
import random

import numpy as np
import pytest

from bluesky_tpu.network.journal import BatchJournal as JJournal
from bluesky_tpu_torch.network.journal import BatchJournal as TJournal
from tests.test_journal_fuzz import _check_fold, _piece, _run_schedule

#: every ``rec`` a journal writes
RECORDS = {"queued", "dispatched", "completed", "crashed", "quarantined",
           "preempted", "mesh_lost", "resharded", "hedged",
           "dup_completed", "opt_result", "perf_regression", "mitigation",
           "sdc_suspect", "sdc_vote", "lease", "adopted", "device_profile",
           "shutdown"}


def _every_record(rng, j):
    """One call of every record method not in the fuzz schedule's
    random walk, with seeded arguments."""
    p = _piece(rng.randint(0, 9))
    w = bytes([0, rng.randint(0, 255), 1, 2, 3])
    j.queued(p)
    j.queued(([0.0], ["SCEN LS0", "FF"]), synthetic=True)
    j.dispatched(p, w, world=rng.randint(0, 7), pack=8)
    j.opt_result(p, w, result={"iters": rng.randint(1, 40),
                               "objective": [rng.random(), 0.5],
                               "bad": -1})
    j.opt_result(p, w, result="not a dict")
    j.perf_regression(p, w)
    j.device_profile(w, dir="output/prof", chunks=rng.randint(1, 9))
    j.device_profile(w)
    j.completed(p, w, world=3)
    j.crashed(p, 1)
    j.quarantined(p, 3)
    j.mesh_lost(p, w)
    j.resharded(p, w)
    j.hedged(p, w, hedge_worker=b"\x00\x09\x09\x09\x09")
    j.dup_completed(p, w)
    j.sdc_suspect(p, fps={w.hex(): "0000beef", "99": "0000dead"},
                  via="audit")
    j.sdc_vote(p, fps={w.hex(): "0000beef"}, deviant=w.hex())
    j.mitigation(cause="queue_flood", signal="queue_depth", action="shed",
                 target="admission", outcome=f"max {rng.randint(9, 99)}")
    j.adopted(p, w)
    j.epoch = rng.randint(1, 3)
    j.lease("some-leader", j.epoch, ttl=rng.random())


def _write(cls, path, seed):
    rng = random.Random(seed)
    ha = {"epoch": 0}
    j = cls(str(path), fsync=False)
    _run_schedule(rng, j, {}, ha=ha)
    _every_record(rng, j)
    j.epoch = None
    _run_schedule(rng, j, {})
    j.shutdown()
    j.close()
    # a torn tail, healed by the next writer (the same calls again)
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) - rng.randint(1, 40)])
    j = cls(str(path), fsync=False)
    _run_schedule(rng, j, {}, ha=ha)
    j.shutdown()
    j.close()
    return j


def _norm(state):
    """A replay dict as comparable data (pieces are tuples of lists)."""
    return json.loads(json.dumps(state, sort_keys=True, default=list))


@pytest.mark.parametrize("seed", range(4))
def test_same_calls_write_the_same_bytes(tmp_path, seed):
    jp, tp = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    jj, tj = _write(JJournal, jp, seed), _write(TJournal, tp, seed)
    jraw, traw = jp.read_bytes(), tp.read_bytes()
    assert traw == jraw
    assert tj.size_bytes == jj.size_bytes > 0
    recs = set()
    for line in jraw.decode().splitlines():
        try:
            recs.add(json.loads(line)["rec"])
        except json.JSONDecodeError:
            pass                     # the healed torn line
    assert RECORDS <= recs, RECORDS - recs


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("strict", [True, False])
def test_each_replay_reads_the_others_file(tmp_path, seed, strict):
    jp, tp = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    _write(JJournal, jp, seed)
    _write(TJournal, tp, seed)
    want = _norm(JJournal.replay(str(jp), fence_strict=strict))
    assert _norm(TJournal.replay(str(jp), fence_strict=strict)) == want
    assert _norm(JJournal.replay(str(tp), fence_strict=strict)) == want
    assert _norm(TJournal.replay(str(tp), fence_strict=strict)) == want
    assert want["torn_lines"] == 1


@pytest.mark.parametrize("seed", [0, 7, 13])
def test_fuzz_exactly_once_through_the_port(tmp_path, seed):
    """JAX's fuzz schedule written by the port's journal, torn at a
    random byte, garbled, and replayed by the port against the
    reference model; JAX's replay of the same file agrees."""
    rng = random.Random(seed)
    path = str(tmp_path / "batch.jsonl")
    model, ha = {}, {"epoch": 0}
    j = TJournal(path, fsync=False)
    _run_schedule(rng, j, model, ha=ha)
    j.close()
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:rng.randint(1, len(raw))])
    state = TJournal.replay(path)
    assert state["torn_lines"] <= 1
    # the torn prefix folds alike in both packages
    assert _norm(state) == _norm(JJournal.replay(path))
    # a clean run on a fresh file, with a garbled line and a torn tail
    path2 = str(tmp_path / "clean.jsonl")
    model = {}
    j = TJournal(path2, fsync=False)
    _run_schedule(rng, j, model)
    j.close()
    with open(path2, "a", encoding="utf-8") as f:
        f.write("not json at all\n")
        f.write('{"rec":"completed","key":"deadbeef')
    state = TJournal.replay(path2)
    assert state["torn_lines"] == 2
    _check_fold(state, model)
    assert _norm(state) == _norm(JJournal.replay(path2))


def test_fence_and_synthetic_as_jax(tmp_path):
    """The deposed leader's late appends are fenced, and synthetic
    pieces are never owed, in the port's replay as in JAX's (the
    deterministic cases of ``tests/test_journal_fuzz.py``)."""
    path = str(tmp_path / "batch.jsonl")
    j = TJournal(path, fsync=False)
    pieces = [_piece(i) for i in range(3)]
    j.epoch = 1
    j.lease("leader-a", 1, ttl=0.5)
    j.queued_many(pieces)
    j.dispatched(pieces[0], b"\x01")
    j.completed(pieces[0], b"\x01")
    j.dispatched(pieces[1], b"\x01")
    j.epoch = 2
    j.lease("leader-b", 2, ttl=0.5)
    j.epoch = 1
    j.completed(pieces[1], b"\x01")
    j.dispatched(pieces[2], b"\x01")
    j.epoch = 2
    j.completed(pieces[2], b"\x02")
    j.epoch = None
    fake = [([0.0], [f"SCEN LS{i}", "FF"]) for i in range(3)]
    j.queued_many(fake, synthetic=True)
    j.completed(fake[0], b"\x01")
    j.close()
    for strict, fenced_pending in ((True, 1), (False, 0)):
        state = TJournal.replay(path, fence_strict=strict)
        assert state["fenced"] == 2
        assert state["ha"]["epoch"] == 2
        assert state["ha"]["leader"] == "leader-b"
        assert len(state["pending"]) == fenced_pending
        assert _norm(state) == _norm(JJournal.replay(path,
                                                     fence_strict=strict))
    state = TJournal.replay(path)
    assert {TJournal.piece_key(p) for p in state["pending"]} \
        == {TJournal.piece_key(pieces[1])}


def test_piece_key_is_jax_and_the_workers():
    from bluesky_tpu_torch.simulation import simnode
    rng = np.random.default_rng(11)
    for _ in range(50):
        n = int(rng.integers(0, 6))
        piece = (rng.uniform(0, 3600, n).tolist(),
                 [f"CRE A{int(i)} B744 {rng.uniform(-90, 90)!r} 4 90 "
                  "FL200 250" for i in rng.integers(0, 999, n)])
        assert TJournal.piece_key(piece) == JJournal.piece_key(piece)
    assert simnode.piece_key is TJournal.piece_key


def test_write_failure_disables_like_jax(tmp_path, capsys):
    """A journal whose directory cannot be made stops writing after the
    first failure and says so, in both packages."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    out = []
    for cls in (JJournal, TJournal):
        j = cls(str(blocker / "sub" / "batch.jsonl"), fsync=False)
        j.queued(_piece(0))
        j.queued(_piece(1))
        assert j._dead and j.size_bytes == 0
        out.append(capsys.readouterr().out.count("disabled after write"))
    assert out == [1, 1]
