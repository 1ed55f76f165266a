"""The port's metrics registry and flight recorder (``obs/metrics.py``,
``obs/trace.py``) and the drains that feed the registry
(``obs/scanstats.drain``, ``obs/fingerprint.drain``), against the JAX
package's on the CPU.

* The same counter, gauge and histogram operations on both registries
  give the same snapshot, delta, merge, human text and Prometheus text.
* The rate-limited export takes its clock as ``now=`` (no dependence on
  the host's uptime): written, skipped inside the interval, written
  after it; the port's first export is never skipped (the JAX copy
  starts its limit at monotonic time 0 and skips it on a host up for
  less than one interval, ROADMAP §C).
* The recorder: a bounded ring, a shared no-op when off, a dump of
  Chrome trace events.
* A stepped chunk's ScanStats and fingerprint packs (JAX's, as host
  arrays, and the port's own) drained into both registries: the same
  summaries, series and chunk fingerprint.
"""
import json

import numpy as np
import pytest
import torch

from bluesky_tpu.core import step as jstep
from bluesky_tpu.obs import fingerprint as jfp, metrics as jmetrics, \
    scanstats as jss
from bluesky_tpu_torch.core import step as tstep
from bluesky_tpu_torch.obs import fingerprint as tfp, metrics as tmetrics, \
    scanstats as tss, trace as ttrace

from torch_parity import build_pair


def _exercise(reg):
    reg.counter("c", help="a counter").inc(3)
    reg.gauge("g", help="a gauge").set(2.5)
    h = reg.histogram("h_ms", help="a histogram")
    for v in (0.1, 3.0, 7.5, 120.0, 1e6):
        h.observe(v)
    first = reg.delta()
    reg.counter("c").inc()
    h.observe(42.0)
    return first, reg.delta()


def test_registry_matches_jax():
    j, t = jmetrics.Registry(), tmetrics.Registry()
    jd, td = _exercise(j), _exercise(t)
    assert td == jd
    assert t.snapshot() == j.snapshot()
    assert t.text() == j.text()
    assert t.prometheus_text() == j.prometheus_text()
    jm, tm = jmetrics.Registry(), tmetrics.Registry()
    jm.merge(jd[0])
    tm.merge(td[0])
    assert tm.snapshot() == jm.snapshot()
    assert t.get("h_ms").percentile(0.5) == j.get("h_ms").percentile(0.5)


def test_export_rate_limit(tmp_path):
    reg = tmetrics.Registry()
    reg.counter("c").inc()
    p = str(tmp_path / "metrics" / "prom.txt")
    assert reg.maybe_export(p, interval=100.0, now=0.0) == p
    assert "# TYPE c counter" in open(p).read()
    reg.counter("c").inc()
    assert reg.maybe_export(p, interval=100.0, now=99.0) is None
    assert "c 1" in open(p).read()
    assert reg.maybe_export(p, interval=100.0, now=100.0) == p
    assert "c 2" in open(p).read()
    assert reg.maybe_export("", interval=1.0, now=500.0) is None


def test_recorder(tmp_path):
    rec = ttrace.Recorder(maxlen=16)
    assert rec.span("x") is ttrace._NULL_SPAN
    rec.instant("off")
    assert len(rec) == 0
    rec.enable()
    for i in range(40):
        with rec.span("chunk_dispatch", seq=i):
            pass
    rec.instant("guard_trip", bad_step=3)
    assert len(rec) == 16
    path = rec.dump(str(tmp_path / "trace.json"), reason="test")
    events = json.load(open(path))
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert [e["name"] for e in events if e.get("ph") != "M"][-1] \
        == "guard_trip"


@pytest.fixture(scope="module")
def packs():
    """JAX's and the port's ScanStats and fingerprint packs of one
    20-step checked chunk of the same dense cluster scene."""
    jstate, tstate = build_pair(32, 24, geom="cluster", pair_matrix=True)
    jcfg = jstep.SimConfig(scanstats=True, fingerprint=True)
    tcfg = tstep.SimConfig(scanstats=True, fingerprint=True)
    _, _, jss_pack, jfp_pack = jstep.run_steps_edge(jstate, jcfg, 20,
                                                    checked=True)
    _, _, tss_pack, tfp_pack = tstep.run_steps_edge(tstate, tcfg, 20,
                                                    checked=True)
    host = lambda p: type(p)(*[np.asarray(x) for x in p])
    return host(jss_pack), host(jfp_pack), tss_pack, tfp_pack


@pytest.mark.parametrize("source", ["jax-pack", "port-pack"])
def test_drains_match_jax(packs, source):
    """JAX's pack drains the same into both registries; the port's own
    pack (a tensor pack) drains as the port's host copy of it does."""
    jss_pack, jfp_pack, tss_pack, tfp_pack = packs
    j, t = jmetrics.Registry(), tmetrics.Registry()
    if source == "jax-pack":
        assert tss.drain(t, jss_pack) == jss.drain(j, jss_pack)
        assert tfp.drain(t, jfp_pack) == jfp.drain(j, jfp_pack)
        assert t.snapshot() == j.snapshot()
        assert t.prometheus_text() == j.prometheus_text()
    else:
        host = type(tss_pack)(*[x.numpy() for x in tss_pack])
        h = tmetrics.Registry()
        assert tss.drain(t, tss_pack) == tss.drain(h, host)
        assert tfp.drain(t, tfp_pack) \
            == tfp.drain(h, type(tfp_pack)(*[x.numpy() for x in tfp_pack]))
        assert t.snapshot() == h.snapshot()
        assert t.get("sim_scan_steps").value == 20
        assert t.get("sim_fp_steps").value == 20
        assert isinstance(tss_pack.steps, torch.Tensor)
