"""The port's mitigation engine (``bluesky_tpu_torch.network.mitigate``)
against the JAX package's, on the CPU.

``TokenBucket`` takes the same tokens on the same clock.  Two unstarted
brokers, one of each package, with the same settings get the same
seeded sequence of signals on a synthetic clock: queue floods and
drains (shed, unshed), fleet memory watermarks (repack, unrepack),
stragglers with and without an idle worker (hedge escalation), degraded
mesh epochs, SDC deviants, and direct gate probes (budget, backoff,
token bucket).  After every signal both engines hold the same decisions
(actions, suppressions, actuator values, readback payload) and both
journals hold the same bytes, the ``mitigation`` records among them.
The off contract holds too: a disabled engine journals nothing.
"""
import random
import re

import pytest

zmq = pytest.importorskip("zmq")

from bluesky_tpu.network.mitigate import TokenBucket as JBucket
from bluesky_tpu.network.server import Server as JServer
from bluesky_tpu_torch.network.mitigate import TokenBucket as TBucket
from bluesky_tpu_torch.network.server import Server as TServer


def test_token_bucket_matches_jax():
    rng = random.Random(3)
    for _ in range(20):
        cap, window = rng.randint(1, 5), rng.uniform(0.5, 20.0)
        jb, tb = JBucket(cap, window), TBucket(cap, window)
        now = 0.0
        for _ in range(60):
            now += rng.choice([0.0, rng.uniform(0.0, window)])
            assert tb.take(now) == jb.take(now)
            assert tb.tokens == jb.tokens


def _wid(i):
    return bytes([0, 0x5a, 0, 0, i])


def _piece(i):
    return ([0.0], [f"SCEN MT{i}", "CRE A1 B744 52 4 90 FL200 250"])


def _bare(cls, path, enabled=True):
    s = cls(headless=True, spawn_workers=False, journal_path=str(path),
            batch_queue_max=12, world_batch_max=8,
            mitigate_enabled=enabled, hedge_enabled=False)
    eng = s.mitigator
    eng.budget_total, eng.rate, eng.rate_window = 60, 2, 30.0
    eng.backoff_base, eng.backoff_cap = 5.0, 40.0
    eng.mem_budget = 1000
    for i in range(6):
        s.workers[_wid(i)] = 2
    return s


def _close(s):
    for sock in (s.fe_event, s.fe_stream, s.be_event, s.be_stream):
        sock.close()
    if s.journal:
        s.journal.close()


def _signal(rng, s, now, step):
    """Apply one seeded signal to broker ``s`` at clock ``now``."""
    eng = s.mitigator
    op = rng.choice(["flood", "drain", "mem", "mem", "tick", "tick",
                     "tick", "straggler", "mesh", "sdc", "admit"])
    if op == "flood":
        s.scenarios.extend([_piece(100 * step + i)
                            for i in range(rng.randint(2, 12))],
                           owner=b"C")
    elif op == "drain":
        for _ in range(rng.randint(1, 20)):
            if s.scenarios:
                s.scenarios.pop_next()
    elif op == "mem":
        s.fleet.gauge("devprof_live_bytes_total").set(
            rng.choice([100, 500, 700, 950, 1200]))
    elif op == "tick":
        eng.tick(now)
    elif op == "straggler":
        slow, piece = _wid(rng.randint(0, 2)), _piece(rng.randint(0, 3))
        if slow not in s.hedge_by and slow not in s.hedge_of:
            s.inflight[slow] = piece
            s.inflight_t[slow] = now
            if rng.random() < 0.6:
                idle = _wid(rng.randint(3, 5))
                if idle not in s.avail_workers and idle not in s.inflight:
                    s.avail_workers.append(idle)
            eng.on_straggler(slow, piece, "stalled", now)
    elif op == "mesh":
        eng.on_mesh_degraded(_wid(rng.randint(0, 5)),
                             _piece(rng.randint(0, 3)),
                             rng.randint(1, 3), rng.choice([2, 3]), now)
    elif op == "sdc":
        eng.on_sdc_deviant(_wid(rng.randint(0, 5)),
                           _piece(rng.randint(0, 3)),
                           rng.choice(["", "fingerprint vote 2-of-3"]),
                           now)
    else:
        # a burst of gate probes: repeats meet the backoff, the fourth
        # of one action within a window the token bucket
        for _ in range(rng.randint(2, 5)):
            eng._admit(rng.choice(["shed", "repack", "hedge_escalate"]),
                       rng.choice(["a", "b", "c", "d"]), now)
    return op


def _masked(text, name):
    return re.sub(r"\d+\.\d+s in flight", "#s in flight",
                  text.replace(name, "J"))


def _bytes(path):
    return path.read_bytes() if path.exists() else b""


def _decisions(s):
    d = s.mitigator.payload()
    return dict(d, batch_queue_max=s.batch_queue_max,
                world_batch_max=s.world_batch_max,
                hedges=s.hedges_started,
                hedge_by=sorted((a.hex(), b.hex())
                                for a, b in s.hedge_by.items()),
                avail=[w.hex() for w in s.avail_workers],
                backoff=sorted(s.mitigator._backoff.items()))


@pytest.mark.parametrize("seed", range(3))
def test_engine_decisions_match_jax(tmp_path, seed, capsys):
    js = _bare(JServer, tmp_path / "jax.jsonl")
    ts = _bare(TServer, tmp_path / "torch.jsonl")
    rj, rt = random.Random(seed), random.Random(seed)
    ops = set()
    try:
        now = 1000.0
        for step in range(150):
            now += rj.uniform(0.0, 8.0)
            rt.uniform(0.0, 8.0)
            ops.add(_signal(rj, js, now, step))
            _signal(rt, ts, now, step)
            assert _decisions(ts) == _decisions(js), step
            assert _bytes(tmp_path / "torch.jsonl") \
                == _bytes(tmp_path / "jax.jsonl"), step
        # MITIGATE OFF restores the actuators alike
        js.mitigator.set_enabled(False)
        ts.mitigator.set_enabled(False)
        acts = js.mitigator.actions
        assert {"shed", "unshed", "repack", "unrepack", "hedge_escalate",
                "accept_degraded", "quarantine_worker"} <= set(acts), acts
        assert set(js.mitigator.suppressed) >= {"backoff", "rate"}
        assert _decisions(ts) == _decisions(js)
        assert _bytes(tmp_path / "torch.jsonl") \
            == _bytes(tmp_path / "jax.jsonl") != b""
        # HEALTH alike, but for the journal's name and the wall-clock
        # ages
        assert _masked(ts.health_payload()["text"], "torch.jsonl") \
            == _masked(js.health_payload()["text"], "jax.jsonl")
    finally:
        _close(js)
        _close(ts)
    capsys.readouterr()


def test_off_engine_is_inert_as_jax(tmp_path):
    js = _bare(JServer, tmp_path / "jax.jsonl", enabled=False)
    ts = _bare(TServer, tmp_path / "torch.jsonl", enabled=False)
    rj, rt = random.Random(9), random.Random(9)
    try:
        for step in range(40):
            _signal(rj, js, 1000.0 + step, step)
            _signal(rt, ts, 1000.0 + step, step)
        assert _decisions(ts) == _decisions(js)
        assert not ts.mitigator.actions and ts.batch_queue_max == 12
        assert "mitigation" not in ts.health_payload()
        assert not (tmp_path / "torch.jsonl").exists()
        assert not (tmp_path / "jax.jsonl").exists()
    finally:
        _close(js)
        _close(ts)
