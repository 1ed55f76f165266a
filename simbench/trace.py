"""Device timing for the per-layer metrics: CUDA events around calls,
and a ``torch.profiler`` window reduced to the device's busy time, the
device operations that took most of it and the longest idle gaps with
what the host was doing in each."""
import json
import os
import shutil
import statistics
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def event_ms(fn, reps: int, sync_each: bool = True):
    """Device milliseconds of ``fn()`` by CUDA events: the median of
    ``reps`` single calls (``sync_each``) or the mean of one run of
    ``reps`` calls."""
    E = lambda: torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if not sync_each:
        a, b = E(), E()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    times = []
    for _ in range(reps):
        a, b = E(), E()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _union(intervals):
    """Merged, sorted ``[(start, end)]`` of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events, window_name: str, top: int = 10) -> dict:
    """Reduce chrome-trace ``events`` to the window named by the user
    annotation ``window_name``: ``window_s``, ``busy_s`` (the union of
    device operations in it), ``device_ops`` (the ``top`` names by
    summed seconds) and ``idle_gaps`` (the ``top`` longest gaps between
    device operations, each named by the innermost host event running
    at its start)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in xs if e.get("cat") == "user_annotation"
            and e.get("name") == window_name]
    if not wins:
        return {}
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) <= w1]
    if not dev:
        return {}
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in dev])
    ops = {}
    for s, e, name in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs if e.get("cat") in HOST_CATS
                   and e["name"] != window_name), key=lambda h: h[0])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges) - 1, 2)
            if edges[k + 1] > edges[k]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def doing(t):
        running = [h for h in host if h[0] <= t <= h[1]]
        return min(running, key=lambda h: h[1] - h[0])[2] if running \
            else "host between calls"
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        device_s=sum(ops.values()),
        device_ops=sorted(([n, v] for n, v in ops.items()),
                          key=lambda x: -x[1])[:top],
        idle_gaps=[[doing(s), (e - s) * 1e-6] for s, e in gaps[:top]])


def profile(fn, window_name: str) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities)
    inside a user annotation ``window_name`` and reduce the trace
    (``reduce_trace``).  The trace file is written to a temporary
    directory and removed."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx, \
        record_function
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(window_name):
            fn()
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="simbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return reduce_trace(events, window_name)
