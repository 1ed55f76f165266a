"""The program's own spans and counters over one traced window, read by
the seven ``program_span`` metrics.

After the other readers have run (the seven come last in
``BENCHMARK.json``), the first of them to ask runs one window of
``WINDOW_CHUNKS`` ``Simulation.step`` chunks of the cell's kind with the
port's flight recorder on and its device timing on
(``sim.recorder.enable(True, device=True)``, what ``TRACE ON DEVICE``
does), drains the pipeline, reads the ring through ``Recorder.dump`` to
a temporary file and switches the recorder off.  The window is 40 chunks
because the sort refresh runs every 30 intervals (``sort_every``), so it
holds at least one.  The events are cached on ``ctx`` for the seven.

What each reader takes (``tid`` ``"cuda stream"`` marks a device-timed
event, the others are the host's):

* ``host_busy_ms``: per ``sim.step`` span, its duration less the union
  of the ``sync`` spans below it; the median over the window's chunks;
* ``host_wait_ms``: per ``sim.step`` span, that union of ``sync`` time;
  the median;
* ``replay_span_ms``: each device ``step.replay`` span (a run of graph
  replays) over its ``steps`` tag; the median;
* ``asas_span_ms``: the device ``asas.interval`` spans; the median;
* ``refresh_span_ms``: the device ``sort_refresh`` spans, at the chunk
  edge or in the chunk; the median;
* ``cd_visit_pct``: the counters ``cd_k1_tiles`` and ``cd_k2_tiles`` of
  the window's last interval (args of its device ``cd.k1`` and ``cd.k2``
  spans), times ``cd_block`` squared pairs a tile, against the pairs
  ``reference/pairs.count_needed`` finds on the window's final state;
* ``span_idle_pct``: the share of the window, from the first device
  span's start to the last one's end, that no leaf device span covers
  (a device span with no device span below it: a parent such as
  ``step.eager`` or ``asas.interval`` would cover the gaps between its
  children).

A program without device spans (its ``Recorder.enable`` takes no
``device``) gets no window, and every reader returns None.
"""
import inspect
import json
import os
import shutil
import statistics
import tempfile

#: chunks of the traced window
WINDOW_CHUNKS = 40
DEVICE_TID = "cuda stream"


def events(ctx):
    """``{"host": [...], "device": [...]}``: the complete events of the
    traced window (run once, cached on ``ctx``); empty lists where the
    program has no device spans."""
    got = getattr(ctx, "spans_window", None)
    if got is None:
        got = ctx.spans_window = _window(ctx)
    return got


def _window(ctx):
    from simbench import drive
    sim = ctx.sim
    rec = getattr(sim, "recorder", None)
    if rec is None or "device" not in inspect.signature(
            rec.enable).parameters:
        return dict(host=[], device=[])
    cs = drive.chunk_steps(ctx.cell)
    sim.drain_pipeline()
    rec.clear()
    rec.enable(True, device=True)
    tmp = tempfile.mkdtemp(prefix="simbench-spans-")
    try:
        for _ in range(WINDOW_CHUNKS):
            sim.step(max_chunk=cs)
        sim.drain_pipeline()
        path = rec.dump(os.path.join(tmp, "ring.json"), reason="simbench")
        evs = []
        if path is not None:
            with open(path) as fh:
                evs = json.load(fh).get("traceEvents", [])
    finally:
        rec.enable(False)
        rec.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    xs = [e for e in evs if e.get("ph") == "X"]
    ctx.note(f"spans: {len(xs)} events of {WINDOW_CHUNKS} chunks, ring "
             f"{len(evs)}/{rec.maxlen}")
    return dict(host=[e for e in xs if e.get("tid") != DEVICE_TID],
                device=[e for e in xs if e.get("tid") == DEVICE_TID])


def union(intervals):
    """Total length of the union of ``[(start, end)]``."""
    total, hi = 0.0, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def median_ms(values_us):
    return statistics.median(values_us) * 1e-3 if values_us else None


def device_ms(ctx, name):
    """Median device milliseconds of the device spans ``name``."""
    return median_ms([float(e["dur"]) for e in events(ctx)["device"]
                      if e["name"] == name])


def step_parts(ctx):
    """``[(duration, sync time)]`` in microseconds of each ``sim.step``
    span: its duration and the union of the ``sync`` spans below it."""
    host = events(ctx)["host"]
    parent = {e["args"].get("id"): e["args"].get("parent") for e in host}
    steps = {e["args"].get("id"): e for e in host if e["name"] == "sim.step"}
    syncs = {k: [] for k in steps}
    for e in host:
        if e["name"] != "sync":
            continue
        p = e["args"].get("parent")
        while p is not None and p not in steps:
            p = parent.get(p)
        if p is not None:
            s = float(e["ts"])
            syncs[p].append((s, s + float(e["dur"])))
    return [(float(e["dur"]), union(syncs[k])) for k, e in steps.items()]


def last_counter(ctx, span, name):
    """The counter ``name`` in the args of the last device span ``span``
    that carries it (None without one)."""
    got = [e for e in events(ctx)["device"]
           if e["name"] == span and name in e["args"]]
    if not got:
        return None
    return max(got, key=lambda e: float(e["ts"]))["args"][name]


def device_leaves(ctx):
    """The device spans with no device span below them (by the ``parent``
    ids of the host and device events)."""
    evs = events(ctx)
    parent = {e["args"].get("id"): e["args"].get("parent")
              for e in evs["host"] + evs["device"]}
    dev = {e["args"].get("id") for e in evs["device"]}
    inner = set()
    for e in evs["device"]:
        p = e["args"].get("parent")
        while p is not None and p not in inner:
            if p in dev:
                inner.add(p)
            p = parent.get(p)
    return [e for e in evs["device"] if e["args"].get("id") not in inner]
