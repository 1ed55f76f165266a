"""Run one cell of ``BENCHMARK.json`` once.

    python3 simbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's fleet from the seed in a ``bluesky_tpu_torch``
``Simulation`` on the card, applies the traffic's stack lines and warms
up the cell's own chunks.  The window then drives ``Simulation.step``
in fast time, chunk after chunk, for ``--seconds``.  After the window
the pipeline drains; one more chunk, started at an ASAS interval, runs
with its state before it copied to the host for the check; ``--trace
1`` reads the cell's per-layer metrics; the program's state is freed
and the plain reference checks that chunk and the run's first
(``simbench/check.py``).  The last line of standard output is the
result as one JSON object; the last lines of standard error are the
compared numbers beside their limits.
"""
import argparse
import json
import os
import statistics
import sys
import time

T_IMPORT = time.perf_counter()
# one host thread for the libraries' pools: the run is one process whose
# host work is a single loop (set before torch is imported)
os.environ["OMP_NUM_THREADS"] = "1"
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "bluesky_tpu"}
TRACE_WINDOW = "simbench.window"
#: chunks of the profiled window of ``--trace 1``
TRACE_CHUNKS = 12


def process_age() -> float:
    """Seconds since this process started (``/proc``; 0 without it)."""
    try:
        with open("/proc/self/stat") as fh:
            start = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_IMPORT = process_age()


def since_start() -> float:
    return AGE_AT_IMPORT + time.perf_counter() - T_IMPORT


def log(*a):
    print("simbench:", *a, file=sys.stderr, flush=True)


def caches():
    """Fixed cache directories inside the checkout for every compiler a
    library of the program may start (the port's own nvcc builds go to
    ``bluesky_tpu_torch/_build``)."""
    base = os.path.join(ROOT, ".simbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def quantile97(values):
    """The 97th percentile by ``statistics.quantiles`` (exclusive)."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=100)[96]


def window_metrics(stamps, t0, n_active, steps_per_chunk):
    """``(rate, p97 ms, chunks, wall s)`` of a window that started at
    ``t0`` and retired a chunk at each of ``stamps`` (the last one ends
    it): aircraft-steps over the whole wall time, and the 97th
    percentile of every gap between retirements, the first from ``t0``."""
    gaps = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    wall = stamps[-1] - t0
    return (n_active * steps_per_chunk * len(stamps) / wall,
            quantile97(gaps), len(stamps), wall)


class Ctx:
    """What a per-layer reader (``simbench/metrics/<name>.py``) gets."""

    def __init__(self, sim, cell, window):
        self.sim, self.cell, self.window = sim, cell, window
        self._profile = None

    def event_ms(self, fn, reps, sync_each=True):
        from simbench import trace
        return trace.event_ms(fn, reps, sync_each)

    def profile(self):
        """The profiled window of ``TRACE_CHUNKS`` chunks (once)."""
        if self._profile is None:
            from simbench import drive, trace
            sim, cs = self.sim, drive.chunk_steps(self.cell)

            def chunks():
                for _ in range(TRACE_CHUNKS):
                    sim.step(max_chunk=cs)
                sim.drain_pipeline()
            self._profile = trace.profile(chunks, TRACE_WINDOW)
        return self._profile

    def profile_call(self, fn):
        from simbench import trace
        return trace.profile(fn, TRACE_WINDOW)

    def note(self, text):
        log(text)


def card_info():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[0] if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def session(args, device="cuda", require_card=True, root=ROOT):
    """Set-up, the window and (``args.trace``) the per-layer metrics of
    one run, the program's state freed at the end.  Returns a dict of
    the result's parts and what the check reads, or None when the run
    cannot be made (no card, too few cards)."""
    import torch
    from simbench import cell as cellmod, check, drive

    cell = cellmod.load(args.workload, root)
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        log(f"needs {cell.chips} CUDA device(s), found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return None
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    split = dict(start_s=AGE_AT_IMPORT, imports_s=time.perf_counter()
                 - T_IMPORT)
    t = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        sync()
    split["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if on_card:
        from bluesky_tpu_torch.ops import _cuda
        for src in _cuda.SIGNATURES:
            _cuda.load(src)
    split["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    sim, cols = drive.build(cell, args.seed, device)
    sync()
    split["fleet_s"] = time.perf_counter() - t
    # the check's own set-up, left out of setup_s: the sample, its rows
    # as created, the host memory of the pre-state
    t = time.perf_counter()
    sample = drive.sample_slots(sim, args.seed)
    start_prog = drive.rows(sim.traf.state, sample)
    pre = drive.PreState(sim.traf.state, sample)
    sync()
    split["check_s"] = time.perf_counter() - t
    t = time.perf_counter()
    first = drive.warm_up(sim, cell, sample)
    split["warmup_s"] = time.perf_counter() - t

    # ---------------------------------------------------------- window
    backend = sim.cfg.cd_backend
    cs = drive.chunk_steps(cell)
    n_active = int(cell.config["fleet"]["n_aircraft"])
    pull = sim.obs.get("sim_edge_pull_ms")
    trips = sim.obs.get("sim_guard_trips")
    pull0, trips0 = pull.sum, trips.value
    ret = drive.Retirements(sim)
    setup_s = since_start() - split["check_s"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        sim.step(max_chunk=cs)
        ret.poll()
    sim.drain_pipeline()
    ret.poll()
    sync()
    rate, p97, chunks, wall = window_metrics(ret.stamps, t0, n_active, cs)
    gaps = [(b - a) * 1e3 for a, b in zip([t0] + ret.stamps[:-1],
                                          ret.stamps)]
    pct = statistics.quantiles(gaps, n=100)
    log("chunk gap percentiles (ms): " + ", ".join(
        f"p{q} {pct[q - 1]:.3f}" for q in (50, 90, 93, 95, 97, 98, 99)))
    window = dict(chunks=chunks, wall_s=wall,
                  edge_pull_ms=pull.sum - pull0)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window: {chunks} chunks in {wall:.3f} s, p97 {p97:.3f} ms, "
        f"{rate:.6g} aircraft-steps/s; set-up {setup_s:.3f} s ({split})")

    # the checked chunk: single steps up to the next ASAS interval, so
    # that the chunk starts with it and the reference's interval reads
    # the program's own state (stepping the fleet first, the reference
    # would meet the speed controls' bang-bang branches of intruders
    # that the resolver amplifies), then one chunk of the window's kind
    align = check.steps_to_interval(drive.clocks(sim.traf.state),
                                    cell.config)
    for _ in range(align):
        sim.step(max_chunk=1)
    log(f"checked chunk: {align} single steps before it")
    pre.take(sim.traf.state, backend)
    sim.step(max_chunk=cs)
    sim.drain_pipeline()
    sync()
    failed = int(trips.value - trips0)
    post = drive.rows(sim.traf.state, sample)
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name() if on_card
                       else "cpu",
                       count=cell.chips, memory_peak_bytes=int(peak))
    metrics, breakdown = {}, None
    if args.trace:
        ctx = Ctx(sim, cell, window)
        prof = ctx.profile()
        device_info.update(busy_s=prof.get("busy_s", 0.0),
                           window_s=prof.get("window_s", 0.0))
        breakdown = dict(device_ops=prof.get("device_ops", []),
                         idle_gaps=prof.get("idle_gaps", []))
        for m in cell.per_layer:
            v = cellmod.reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        e2e = dict(aircraft_steps_per_s=rate, chunk_p97_ms=p97,
                   peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = dict(value=float(e2e[m["name"]]),
                                          unit=m["unit"])

    # the program's state goes before the reference runs
    from bluesky_tpu_torch.core import graph
    pre_np = pre.numpy(backend)
    del sim, pre
    graph.clear()
    import gc
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(cell=cell, chunks=chunks, failed=failed, metrics=metrics,
                device=device_info, breakdown=breakdown, setup=split,
                pre=pre_np, sample=sample, cols=cols, chunk_steps=cs,
                prog=dict(start=start_prog, first=drive.host(first),
                          last=post))


def references(s, device="cuda", dtype=None, store_dtype=None):
    """The reference's side of a session, as ``check.compare`` reads it:
    ``start`` (its construction of the sampled aircraft), ``first`` (its
    first chunk from its own start) and ``last`` (the last chunk from the
    captured state), computed in ``dtype`` (float64) and stored between
    steps in ``store_dtype`` (the configuration's dtype)."""
    import torch
    from simbench import check
    dtype = dtype or torch.float64
    cfg, sample = s["cell"].config, s["sample"]
    go = lambda pre: check.to_numpy(check.run_reference(
        pre, sample, cfg, s["chunk_steps"], dtype=dtype,
        store_dtype=store_dtype, device=device))
    return dict(start=check.start_reference(s["cols"], sample, dtype),
                first=go(check.start_state(s["cols"], sample, cfg, dtype,
                                           store_dtype)),
                last=go(s["pre"]))


def verdict(s, device="cuda"):
    """``(correct, [(name, value, limit)], reference)`` of a session:
    the reference's side (``references``) against the program's."""
    from simbench import check
    t = time.perf_counter()
    ref = references(s, device)
    nums = check.compare(s["prog"], ref)
    correct, rows = check.judge(nums, s["cell"].limits)
    if not check.cruise_only(s["pre"]):
        log("check: the state before the chunk has aircraft on a route, "
            "which the reference does not follow")
        correct = False
    log(f"check: {time.perf_counter() - t:.3f} s, first chunk "
        f"{check.excused(ref['first'])}, last {check.excused(ref['last'])}")
    return correct, rows, ref


def run(args, device="cuda", require_card=True, root=ROOT):
    """One run; returns the result dict (None when the run cannot be
    made)."""
    s = session(args, device, require_card, root)
    if s is None:
        return None
    correct, rows, _ = verdict(s, device)
    result = dict(correct=correct, attempted=s["chunks"], failed=s["failed"],
                  metrics=s["metrics"], device=s["device"])
    if s["breakdown"] is not None:
        result["breakdown"] = s["breakdown"]
    result["setup"] = s["setup"]
    result["card"] = card_info() if s["device"]["platform"] == "gpu" \
        else "cpu"
    result["check"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    caches()
    sys.path.insert(0, ROOT)
    try:
        import bluesky_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        log(f"the program is missing from this checkout: {e}")
        return 2
    result = run(args)
    if result is None:
        return 2
    bad = forbidden_modules()
    if bad:
        log(f"modules of the JAX side were loaded: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
