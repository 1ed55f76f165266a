"""Profiling hooks: ``torch.profiler`` trace capture and per-kernel wall
timings (port of ``bluesky_tpu/utils/profiler.py``).

The PROFILE stack command starts and stops a ``torch.profiler`` trace
(a Chrome trace-event JSON file, viewable in Perfetto), and times the
pieces of a step on the current traffic so the chunk rate can be
decomposed: ``kernel_timings`` (PROFILE KERNELS) the chunk, the CD and
the MVP resolution; ``deep_timings`` (PROFILE DEEP) the CD overhead and
pair-cost probes, the spatial sort and the MVP tail.  Each time is the
best of ``reps`` after one warm call: CUDA events on the card,
``perf_counter`` on the CPU.  PROFILE DEVICE (``obs/devprof.py``) and
PROFILE TRACE (the flight recorder) are the command's other forms.
"""
import os
import time

import torch

_TRACE = {}          # the running trace: {"prof": profile, "dir": logdir}


def start_trace(logdir="output/torch-trace"):
    """Start a ``torch.profiler`` trace of the CPU and (on a machine with
    CUDA) the card; ``stop_trace`` writes it into ``logdir``.  Returns
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile
    if _TRACE:
        raise RuntimeError(f"a trace into {_TRACE['dir']} is running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    _TRACE.update(prof=prof, dir=logdir)
    return logdir


def stop_trace():
    """Stop the running trace and write its Chrome trace JSON; returns
    the file's path."""
    if not _TRACE:
        raise RuntimeError("no trace is running")
    prof, logdir = _TRACE.pop("prof"), _TRACE.pop("dir")
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def best_ms(fn, reps=3, device=None):
    """The least wall time [ms] of ``reps`` calls of ``fn`` after one warm
    call: between two CUDA events on a CUDA ``device``, by
    ``perf_counter`` on the CPU."""
    fn()
    cuda = device is not None and torch.device(device).type == "cuda"
    best = float("inf")
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def _mvpcfg(acfg):
    from ..ops import cr_mvp
    return cr_mvp.MVPConfig(rpz_m=acfg.rpz_m, hpz_m=acfg.hpz_m,
                            tlookahead=acfg.dtlookahead)


def _cd_cols(ac, noreso):
    return (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, noreso)


def kernel_timings(sim, nsteps=50, reps=3):
    """Per-kernel wall timings [ms] at the current traffic: one chunk of
    ``nsteps`` steps (``run_steps_edge_keep``, which leaves the
    Simulation's state as it is), then the backend's CD alone (dense:
    ``cd.detect`` and ``cr_mvp.resolve``; tiled ``detect_resolve_tiled``;
    pallas and sparse ``detect_resolve_pallas``, as JAX times both, and
    for sparse also ``detect_resolve_sched`` without a partner table,
    the no-resume form of its segment pass)."""
    from ..core.step import run_steps_edge_keep
    from ..ops import cd as cdops, cd_pallas, cd_sched, cd_tiled, cr_mvp
    sim.traf.flush()
    state = sim.traf.state
    cfg = sim.cfg
    ac, acfg = state.ac, cfg.asas
    dev = state.device
    mvpcfg = _mvpcfg(acfg)
    cd_args = _cd_cols(ac, state.asas.noreso) + (acfg.rpz, acfg.hpz,
                                                 acfg.dtlookahead, mvpcfg)
    timings = {}
    ms = best_ms(lambda: run_steps_edge_keep(state, cfg, nsteps), reps, dev)
    timings[f"step_chunk[{nsteps}]"] = ms
    timings["per_sim_step"] = ms / nsteps
    if cfg.cd_backend == "dense":
        cdout = cdops.detect(ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                             ac.active, acfg.rpz, acfg.hpz, acfg.dtlookahead)
        timings["cd_detect"] = best_ms(lambda: cdops.detect(
            ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.active,
            acfg.rpz, acfg.hpz, acfg.dtlookahead), reps, dev)
        timings["mvp_resolve"] = best_ms(lambda: cr_mvp.resolve(
            cdout, ac.alt, ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs,
            ac.selalt, state.ap.vs, state.asas.alt, acfg.vmin, acfg.vmax,
            acfg.vsmin, acfg.vsmax, mvpcfg), reps, dev)
    elif cfg.cd_backend == "tiled":
        timings["cd_tiled"] = best_ms(lambda: cd_tiled.detect_resolve_tiled(
            *cd_args, block=cfg.cd_block), reps, dev)
    else:
        timings["cd_pallas"] = best_ms(
            lambda: cd_pallas.detect_resolve_pallas(
                *cd_args, block=cfg.cd_block), reps, dev)
        if cfg.cd_backend == "sparse":
            timings["cd_sched"] = best_ms(
                lambda: cd_sched.detect_resolve_sched(
                    *cd_args, block=cfg.cd_block), reps, dev)
    return timings


def report(sim, nsteps=50):
    t = kernel_timings(sim, nsteps)
    n = sim.traf.ntraf
    lines = [f"Kernel timings at N={n} ({sim.cfg.cd_backend} backend):"]
    for name, ms in t.items():
        lines.append(f"  {name}: {ms:.3f} ms")
    if "per_sim_step" in t and t["per_sim_step"] > 0:
        rate = n * 1000.0 / t["per_sim_step"]
        lines.append(f"  -> {rate:,.0f} aircraft-steps/s")
    return "\n".join(lines)


def _deep_kernel(sim, ac):
    """``(kern, perm, unsorted)`` of the deep sweep's CD probes on the
    Simulation's backend, or None for dense: ``kern(active, **kw)`` runs
    the CD on the state's columns with ``active``; ``perm`` is the
    cached order (Morton for tiled and pallas, the stripe destinations
    for sparse); ``unsorted`` the keywords that defeat the sort (tiled
    and pallas ``spatial_sort=False``, sparse the caller order as the
    layout)."""
    from ..ops import cd_pallas, cd_sched, cd_tiled
    state = sim.traf.state
    acfg = sim.cfg.asas
    backend = sim.cfg.cd_backend
    block = sim.cfg.cd_block
    tail = (acfg.rpz, acfg.hpz, acfg.dtlookahead, _mvpcfg(acfg))
    cols = _cd_cols(ac, state.asas.noreso)
    if backend in ("tiled", "pallas"):
        fn = (cd_pallas.detect_resolve_pallas if backend == "pallas"
              else cd_tiled.detect_resolve_tiled)
        perm = cd_tiled.spatial_permutation(ac.lat, ac.lon, ac.active) \
            .to(torch.int32)
        return (lambda active, **kw: fn(*cols[:8], active, cols[9], *tail,
                                        block=block, **kw),
                perm, dict(spatial_sort=False))
    if backend == "sparse":
        f32 = lambda a: a.to(torch.float32)
        perm = cd_sched.stripe_sort_dest(
            f32(ac.lat), f32(ac.lon), f32(ac.gs), ac.active,
            cd_sched.reach_threshold_m(f32(ac.gs), ac.active,
                                       float(acfg.dtlookahead),
                                       float(acfg.rpz)), min(block, 256),
            32)
        caller = torch.arange(ac.lat.shape[0], dtype=torch.int32,
                              device=ac.lat.device)
        return (lambda active, **kw: cd_sched.detect_resolve_sched(
            *cols[:8], active, cols[9], *tail, block=block, **kw),
            perm, dict(perm=caller))
    return None


def deep_timings(sim, reps=3):
    """The decomposition sweep on the current traffic: the Morton
    argsort (``spatial_permutation``) on every backend; on tiled,
    pallas and sparse the CD with the cached order (``cd_sweep``), with
    every aircraft inactive (``cd_all_inactive``: what is left is the
    pass's overhead), with the sort defeated (``cd_unsorted``: the pair
    cost the sort saves) and the MVP tail (``resolve_from_sums`` plus
    the partner bookkeeping of ``cd_tiled.partner_keep``,
    ``topk_partners`` and ``merge_partners``).  Dense gets the argsort
    only (its CD has no tiles to skip)."""
    from ..ops import cd_tiled, cr_mvp
    sim.traf.flush()
    state = sim.traf.state
    ac, asas = state.ac, state.asas
    acfg = sim.cfg.asas
    dev = state.device
    timings = {"spatial_permutation": best_ms(
        lambda: cd_tiled.spatial_permutation(ac.lat, ac.lon, ac.active),
        reps, dev)}
    probe = _deep_kernel(sim, ac)
    if probe is None:
        return timings
    kern, perm, unsorted = probe
    timings["cd_sweep"] = best_ms(lambda: kern(ac.active, perm=perm),
                                  reps, dev)
    inact = torch.zeros_like(ac.active)
    timings["cd_all_inactive"] = best_ms(lambda: kern(inact, perm=perm),
                                         reps, dev)
    timings["cd_unsorted"] = best_ms(lambda: kern(ac.active, **unsorted),
                                     reps, dev)
    rd = kern(ac.active, perm=perm)
    mcfg = _mvpcfg(acfg)
    k = asas.partners.shape[-1]

    def tail():
        out = cr_mvp.resolve_from_sums(
            rd.sum_dve, rd.sum_dvn, rd.sum_dvv, rd.tsolv, ac.alt,
            ac.gseast, ac.gsnorth, ac.vs, ac.trk, ac.gs, ac.selalt,
            state.ap.vs, asas.alt, acfg.vmin, acfg.vmax, acfg.vsmin,
            acfg.vsmax, mcfg, resooff=asas.resooff)
        keep = cd_tiled.partner_keep(
            asas.partners, ac.lat, ac.lon, ac.gseast, ac.gsnorth, ac.trk,
            ac.active, acfg.rpz, acfg.rpz_m)
        merged = cd_tiled.merge_partners(cd_tiled.topk_partners(rd, k),
                                         asas.partners, keep)
        return out[0], merged
    timings["mvp_tail"] = best_ms(tail, reps, dev)
    return timings


def deep_report(sim):
    t = deep_timings(sim)
    lines = [f"Deep sweep at N={sim.traf.ntraf} "
             f"({sim.cfg.cd_backend} backend):"]
    for name, ms in t.items():
        lines.append(f"  {name}: {ms:.3f} ms")
    if "cd_sweep" in t:
        lines.append(
            f"  -> overhead floor {t['cd_all_inactive']:.3f} ms, "
            f"prefilter saves "
            f"{t['cd_unsorted'] - t['cd_sweep']:.3f} ms/sweep")
    # the device memory watermarks (live / peak bytes per device, a
    # forced sample so the lines appear with devprof_mem_dt = 0)
    dp = getattr(sim, "devprof", None)
    if dp is not None:
        dp.sample_memory(force=True)
        wm = dp.watermarks()
        if wm:
            lines.append("  device memory (live / peak):")
            for did in sorted(wm):
                live, peak = wm[did]
                lines.append(f"    dev{did}: {live / 1e6:8.2f} MB / "
                             f"{peak / 1e6:8.2f} MB")
    return "\n".join(lines)
