"""The port's spans and counters (``obs/trace.py`` and its sites on the
chunk path), on the CPU with a small sparse cell, and one card case.

* Off: ``span()`` is the shared no-op and a run leaves the ring empty.
* The bridge: under a CPU ``torch.profiler`` the spans are
  ``user_annotation`` events of the Chrome trace, nested as they are.
* The ring: every span an ``id``, its ``parent`` and the chunk's ``seq``,
  a child's interval inside its parent's.
* Tracing on (with the counters) leaves the stepped state bit-equal.
* The interval's counters equal the tile counts of ``window_items`` and
  of ``reach & overflow`` on the same inputs; ``sim_host_syncs`` counts
  the ``sync`` spans, one a wait (CPU edges given a completion event);
  ``TRACE ON DEVICE`` is refused on a CPU state.
* The benchmark's span readers (``simbench/spans.py``): the host ones
  read the ring, the device ones find nothing on the CPU; the idle
  share is taken over the leaf device spans.
* ``scripts/torch_trace_report.py`` tabulates a dump per chunk.
* On the card (``gpu``): device timing adds no host sync to a chunk,
  and the device spans resolve inside ``asas.interval``.
"""
import json
import types

import pytest
import torch

from bluesky_tpu_torch.core import graph
from bluesky_tpu_torch.obs import metrics as obs_metrics
from bluesky_tpu_torch.obs import trace
from bluesky_tpu_torch.ops import cd_sched

from torch_parity import no_pacing, sim_do

N_AC = 600
CHUNK = 20


def _cell():
    """The circle cell's configuration and traffic at 600 aircraft in a
    0.3 degree disc (``simbench/tests/tiny.py``'s size)."""
    from simbench import cell as cellmod
    c = cellmod.load("circle-100k.sparse-mvp")
    cfg = json.loads(json.dumps(c.config))
    cfg.update(nmax=640)
    cfg["fleet"].update(n_aircraft=N_AC, radius_deg=0.3)
    return c._replace(config=cfg)


def _sim(device="cpu", cell=None, seed=7):
    from simbench import drive
    return drive.build(cell or _cell(), seed, device)[0]


def _chunks(sim, n, drain=True):
    for _ in range(n):
        sim.step(max_chunk=CHUNK)
    if drain:
        sim.drain_pipeline()


class _Done:
    """A CPU chunk's completion event: its wait returns at once."""

    def synchronize(self):
        pass


def _waiting_edges(mp):
    """Give each CPU chunk edge a completion event, so that retiring it
    waits (a ``sync``) as on the card."""
    from bluesky_tpu_torch.simulation import pipeline
    copy = pipeline._host_copy
    mp.setattr(pipeline, "_host_copy", lambda tree: (copy(tree)[0],
                                                     _Done()))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    no_pacing(monkeypatch)
    graph.clear()
    rec = trace.get_recorder()
    rec.disable()
    rec.clear()
    yield rec
    rec.disable()
    rec.clear()


def _host(rec):
    return [e for e in rec._ring if e.get("ph") == "X"
            and e["tid"] != trace.DEVICE_TID]


def test_off_is_the_null_span_and_leaves_the_ring_empty(_fresh):
    rec = _fresh
    assert rec.span("sim.step", seq=1) is trace._NULL_SPAN
    assert rec.span("cd.k1", device=True) is trace._NULL_SPAN
    sim = _sim()
    _chunks(sim, 2)
    assert len(rec) == 0 and not rec._pending
    assert sim.obs.get("cd_k1_tiles").value == 0


def _contains(outer, inner, tol=0.0):
    s0, s1 = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    t0, t1 = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    return s0 - tol <= t0 and t1 <= s1 + tol


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """The user annotations of a CPU ``torch.profiler`` run of three
    chunks whose edges wait, the recorder off; and the ring's length
    after."""
    from torch.profiler import ProfilerActivity, profile
    with pytest.MonkeyPatch.context() as mp:
        no_pacing(mp)
        _waiting_edges(mp)
        graph.clear()
        rec = trace.get_recorder()
        rec.disable()
        rec.clear()
        sim = _sim()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _chunks(sim, 3, drain=False)
        sim.drain_pipeline()
    path = str(tmp_path_factory.mktemp("prof") / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        evs = [e for e in json.load(fh)["traceEvents"]
               if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return evs, len(rec)


@pytest.mark.parametrize("child,parent", [
    ("sim.plan", "sim.step"), ("chunk_dispatch", "sim.step"),
    ("sim.edge", "sim.step sync"), ("asas.interval", "chunk_dispatch"),
    ("cd.k1", "asas.interval"), ("cd.k2", "asas.interval"),
    ("cr.resolve", "asas.interval"), ("asas.partners", "asas.interval"),
    ("sync", "sim.edge"), ("cd.back", "asas.interval"),
    ("step.pre", "chunk_dispatch"), ("step.post", "chunk_dispatch")])
def test_profiler_annotations_nest_as_the_spans(profiled, child, parent):
    """The recorder off, a CPU profiler on: the spans are the trace's
    user annotations, each ``child`` inside one of ``parent`` (an edge
    retires inside the next chunk's ``sim.step``, and waits there)."""
    evs, ring = profiled
    names = {e["name"] for e in evs}
    assert {"sim.step", "sim.edge", "asas.interval", "cd.k1",
            "sync"} <= names
    kids = [e for e in evs if e["name"] == child]
    dads = [e for e in evs if e["name"] in parent.split()]
    assert kids and all(any(_contains(d, k) for d in dads) for k in kids)
    assert ring == 0


def test_ring_events_carry_id_parent_and_seq(_fresh):
    rec = _fresh
    sim = _sim()
    rec.enable()
    _chunks(sim, 3)
    host = _host(rec)
    by_id = {e["args"]["id"]: e for e in host}
    assert len(by_id) == len(host)
    steps = [e for e in host if e["name"] == "sim.step"]
    assert [e["args"]["seq"] for e in steps] == [1, 2, 3]
    inner = 0
    for e in host:
        p = e["args"]["parent"]
        if p is None:
            continue
        inner += 1
        dad = by_id[p]
        assert _contains(dad, e, tol=1e-3), (e["name"], dad["name"])
        if e["name"] not in ("sim.edge", "sync"):
            assert e["args"]["seq"] == dad["args"]["seq"], e["name"]
    assert inner > 20
    # an edge retires its own chunk inside the next chunk's sim.step
    edges = [e for e in host if e["name"] == "sim.edge"]
    assert sorted(e["args"]["seq"] for e in edges) == [1, 2, 3]
    names = {e["name"] for e in host}
    assert {"cd.prepare", "cd.k1", "cd.k2", "cr.resolve", "asas.partners",
            "step.pack", "sort_refresh", "sim.plan"} <= names


def test_tracing_on_leaves_the_state_bit_equal(_fresh):
    rec = _fresh
    out = []
    for on in (False, True):
        graph.clear()
        rec.clear()
        rec.enable(on, device=on)
        sim = _sim()
        _chunks(sim, 3)
        out.append([t.clone() for _, t in graph.leaves(sim.traf.state)])
        rec.disable()
    assert len(rec) > 0
    for a, b in zip(*out, strict=True):
        assert torch.equal(a, b)


def test_cd_counters_equal_the_tile_counts(_fresh, monkeypatch):
    """Windows one block wide and one segment long push rows to the
    overflow pass, so both counters count tiles."""
    rec = _fresh
    seen = []
    run_kernels, build_windows = cd_sched.run_kernels, cd_sched.build_windows
    monkeypatch.setattr(cd_sched, "run_kernels",
                        lambda x, p: seen.append(x) or run_kernels(x, p))
    monkeypatch.setattr(cd_sched, "build_windows",
                        lambda reach, s_cap, wmax, pad_start:
                        build_windows(reach, 1, 1, pad_start))
    sim = _sim()
    rec.enable(True, device=True)
    _chunks(sim, 2)
    k1 = items = k2 = rows = 0
    for x in seen:
        length = cd_sched.window_items(x.wst, x.wln, int(x.wmax),
                                       x.nb).length
        k1 += int(length.sum())
        items += int((length > 0).sum())
        k2 += int((x.reach & x.overflow[:, None]).sum())
        rows += int(x.overflow.sum())
    assert len(seen) == 2 and k2 > 0 and rows > 0
    got = {n: sim.obs.get(n).value for n in ("cd_k1_tiles", "cd_items",
                                             "cd_k2_tiles",
                                             "cd_overflow_rows")}
    assert got == dict(cd_k1_tiles=k1, cd_items=items, cd_k2_tiles=k2,
                       cd_overflow_rows=rows)


@pytest.mark.parametrize("seed,wmax", [(0, 16), (1, 4), (2, 32)])
def test_k1_counters_match_window_items(_fresh, monkeypatch, seed, wmax):
    """Random windows, rows of up to ``s_cap * wmax`` tiles (past the
    eight items a row): ``cd_items`` and ``cd_k1_tiles`` as
    ``window_items`` cuts them; the passes themselves stubbed out."""
    rec = _fresh
    g = torch.Generator().manual_seed(seed)
    nb, s_cap = 48, 6
    wst = torch.randint(0, nb + 1, (nb, s_cap), generator=g,
                        dtype=torch.int32)
    wln = torch.randint(-1, wmax + 8, (nb, s_cap), generator=g,
                        dtype=torch.int32)
    x = cd_sched.SchedInputs(
        packed=None, wst=wst, wln=wln, wmax=wmax,
        overflow=torch.zeros(nb, dtype=torch.bool),
        reach=torch.zeros((nb, nb), dtype=torch.bool), pold=None,
        perm=None, n=0, n_tot=nb * 256, nb=nb, block=256)
    zero = [torch.zeros((nb, 1, 1))]
    monkeypatch.setattr(cd_sched, "sched_tiles", lambda *a, **k: zero)
    monkeypatch.setattr(cd_sched, "_overflow_pass", lambda *a, **k: zero)
    rec.enable(True, device=True)
    with rec.span("asas.interval"):
        cd_sched.run_kernels(x, None)
    reg = obs_metrics.Registry()
    rec.resolve(reg)
    length = cd_sched.window_items(wst, wln, wmax, nb).length
    assert int(length.sum(1).max()) > 2 * 8
    assert reg.get("cd_k1_tiles").value == int(length.sum())
    assert reg.get("cd_items").value == int((length > 0).sum())


def test_host_syncs_count_the_sync_spans(_fresh, monkeypatch):
    rec = _fresh
    _waiting_edges(monkeypatch)
    sim = _sim()
    _chunks(sim, 1)
    syncs = sim.obs.get("sim_host_syncs")
    before = syncs.value
    rec.enable()
    _chunks(sim, 3)
    sim.drain_pipeline()
    n = sum(e["name"] == "sync" for e in _host(rec))
    assert n >= 3 and syncs.value - before == n


def test_one_drain_of_one_chunk_is_one_sync(_fresh, monkeypatch):
    """Draining one chunk in flight waits once, and a drain with nothing
    in flight waits not at all."""
    _waiting_edges(monkeypatch)
    sim = _sim()
    _chunks(sim, 2)
    syncs = sim.obs.get("sim_host_syncs")
    sim.step(max_chunk=CHUNK)
    assert sim._pending_edge is not None
    before = syncs.value
    sim.drain_pipeline()
    assert syncs.value - before == 1
    sim.drain_pipeline()
    assert syncs.value - before == 1


def test_trace_on_device_needs_a_card(_fresh):
    sim = _sim()
    out = " ".join(sim_do(sim, "TRACE ON DEVICE"))
    assert "unavailable on cpu" in out and not _fresh.enabled
    assert "Flight recorder ON" in " ".join(sim_do(sim, "TRACE ON"))
    assert "TRACE ON (" in " ".join(sim_do(sim, "TRACE"))


def test_span_readers_of_the_benchmark(_fresh):
    """``simbench/spans.py`` on a CPU run: the host readers read the
    ring's ``sim.step`` and ``sync`` spans, the device readers find no
    device span and return None; the recorder is off afterwards."""
    from simbench import cell as cellmod, spans
    cell = _cell()
    sim = _sim(cell=cell)
    _chunks(sim, 1)
    notes = []
    ctx = types.SimpleNamespace(sim=sim, cell=cell, note=notes.append)
    got = {m: cellmod.reader(m)(ctx) for m in (
        "host_busy_ms", "host_wait_ms", "replay_span_ms", "asas_span_ms",
        "refresh_span_ms", "cd_visit_pct", "span_idle_pct")}
    assert got["host_busy_ms"] > 0 and got["host_wait_ms"] >= 0
    assert all(got[m] is None for m in ("replay_span_ms", "asas_span_ms",
                                        "refresh_span_ms", "cd_visit_pct",
                                        "span_idle_pct"))
    steps = spans.step_parts(ctx)
    assert len(steps) == spans.WINDOW_CHUNKS
    assert all(d >= w >= 0 for d, w in steps)
    assert not _fresh.enabled and len(_fresh) == 0 and notes


def test_span_idle_takes_the_leaf_device_spans():
    """A parent's device span covers the gap between its children; the
    idle share counts that gap, and a span below a host span is a leaf."""
    from simbench import spans

    def ev(i, parent, ts, dur):
        return {"args": {"id": i, "parent": parent}, "ts": ts, "dur": dur}

    host = [ev(1, None, 0, 100), ev(2, 1, 0, 100), ev(4, 1, 0, 100),
            ev(5, 4, 0, 100), ev(6, 4, 0, 100), ev(7, 1, 0, 100)]
    dev = [ev(2, 1, 0, 10), ev(4, 1, 10, 80), ev(5, 4, 10, 30),
           ev(6, 4, 60, 30), ev(7, 1, 90, 10)]
    ctx = types.SimpleNamespace(spans_window=dict(host=host, device=dev))
    assert sorted(e["args"]["id"] for e in spans.device_leaves(ctx)) \
        == [2, 5, 6, 7]
    from simbench import cell as cellmod
    assert cellmod.reader("span_idle_pct")(ctx) == pytest.approx(20.0)


def test_trace_report_tabulates_the_chunks(_fresh, tmp_path):
    """``scripts/torch_trace_report.py`` on a CPU dump of three chunks:
    one row a chunk, its ``sim.step`` and ``sim.edge`` host ms and the
    latency that ``sim.edge`` carries, as the ring has them."""
    import os
    import subprocess
    import sys
    rec = _fresh
    sim = _sim()
    rec.enable()
    _chunks(sim, 3)
    dump = rec.dump(str(tmp_path / "trace.json"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "scripts",
                                      "torch_trace_report.py"), dump,
         "-o", str(tmp_path / "merged.json")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    head = next(i for i, ln in enumerate(lines)
                if ln.split()[:3] == ["pid", "seq", "chunk"])
    rows = [ln.split() for ln in lines[head + 2:]]
    assert [int(r[1]) for r in rows] == [1, 2, 3]
    host = _host(rec)
    for r in rows:
        seq = int(r[1])
        step = next(e for e in host if e["name"] == "sim.step"
                    and e["args"]["seq"] == seq)
        edge = next(e for e in host if e["name"] == "sim.edge"
                    and e["args"]["seq"] == seq)
        assert r[2] == str(CHUNK)
        assert float(r[3]) == pytest.approx(step["dur"] / 1e3, abs=1e-3)
        assert float(r[5]) == pytest.approx(edge["dur"] / 1e3, abs=1e-3)
        assert float(r[6]) == edge["args"]["latency_ms"] > 0
    with open(tmp_path / "merged.json") as fh:
        assert len(json.load(fh)["traceEvents"]) == len(rec)


def test_union_of_intervals():
    from simbench import spans
    assert spans.union([]) == 0
    assert spans.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_resolve_waits_for_nothing_and_keeps_unfinished_spans():
    """A device span whose end has not fired stays pending; its counters
    reach the registry once it has."""
    class Late:
        def __init__(self):
            self.done = False

        def query(self):
            return self.done

    rec = trace.Recorder()
    rec.enable(True, device=True)
    end = Late()
    rec._pending.append(("cd.k1", "cd", {"seq": 4}, None, end,
                         ["cd_k1_tiles"], torch.tensor([7])))
    reg = obs_metrics.Registry()
    assert rec.resolve(reg) == 0 and len(rec._pending) == 1
    end.done = True
    assert rec.resolve(reg) == 1 and not rec._pending
    assert reg.get("cd_k1_tiles").value == 7


# ------------------------------------------------------------- the card
@pytest.mark.gpu
def test_device_timing_adds_no_sync_and_nests(_fresh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings
    rec = _fresh
    cell = _cell()
    cell.config["fleet"].update(n_aircraft=20000, radius_deg=2.0)
    cell.config.update(nmax=20480)
    sim = _sim("cuda", cell)
    _chunks(sim, 3)

    def syncs():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                sim.step(max_chunk=CHUNK)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in seen)

    off = [syncs() for _ in range(4)]
    rec.enable(True, device=True)
    on = [syncs() for _ in range(4)]
    sim.drain_pipeline()
    assert on == off
    dev = [e for e in rec._ring if e["tid"] == trace.DEVICE_TID]
    ivs = {e["args"]["id"]: e for e in dev if e["name"] == "asas.interval"}
    kids = [e for e in dev if e["name"] in ("cd.prepare", "cd.k1", "cd.k2",
                                            "cd.back", "cr.resolve",
                                            "asas.partners")]
    assert len(ivs) >= 4 and len(kids) == 6 * len(ivs)
    for e in dev:
        assert e["dur"] > 0, e["name"]
    for k in kids:
        assert _contains(ivs[k["args"]["parent"]], k, tol=1.0), k["name"]
    # every device span inside its nearest device-timed ancestor's
    parent = {e["args"]["id"]: e["args"]["parent"] for e in _host(rec)}
    by_id = {e["args"]["id"]: e for e in dev}
    nested = 0
    for e in dev:
        p = e["args"]["parent"]
        while p is not None and p not in by_id:
            p = parent.get(p)
        if p is not None:
            nested += 1
            assert _contains(by_id[p], e, tol=1.0), (e["name"],
                                                     by_id[p]["name"])
    assert nested >= 10 * len(ivs)
    # the eager step's leaves: before, the interval, after, the folds
    host = {e["args"]["id"]: e for e in _host(rec)}
    eager = {e["args"]["id"]: e for e in dev if e["name"] == "step.eager"}
    for name in ("step.pre", "asas.interval", "step.post", "step.fold"):
        got = [e for e in dev if e["name"] == name
               and host[e["args"]["id"]]["args"]["parent"] in eager]
        assert len(got) == len(eager) >= 4, name
        for e in got:
            dad = eager[host[e["args"]["id"]]["args"]["parent"]]
            assert _contains(dad, e, tol=1.0), name
    assert sim.obs.get("cd_k1_tiles").value > 0
