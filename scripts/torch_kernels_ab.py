#!/usr/bin/env python3
"""K2 (``_kernel_resume``) and K4 (``_kernel_cand``) of
``bluesky_tpu_torch/csrc/cd_tiles.cu`` against the one-CTA-per-row build
of that source at commit aa6415a, in one process on one card:

    mkdir -p _chipcheck
    git show aa6415a:bluesky_tpu_torch/csrc/cd_tiles.cu \\
        > _chipcheck/old_cd_tiles.cu
    python3 scripts/torch_kernels_ab.py _chipcheck/old_cd_tiles.cu \\
        [--rounds 2] [--per-row 4 8 16]

The earlier source must have the C interface of aa6415a for the two
kernels (``OLD_SIGNATURES``: ``cd_full_grid_resume(packed, nb, B, reach,
pold, ...)``, ``cd_cand_tiles(packed, nb, B, cand, c_cap, ...)``).  It is
built with the flags of ``ops/_cuda.py`` (its ``-Xptxas -v`` register
lines are printed) into ``bluesky_tpu_torch/_build/``.  The cases:

* K2 on the regional clump of ``chip_smoke.check_kernels`` (N=8,192,
  ``s_cap=2``, the second interval), where it has overflow rows;
* K2 on the main path: 100,000 continental aircraft, the sparse backend
  stepped 2 x 20 steps, the next interval's operands (no overflow row);
* K4 on the pallas backend's stepped 100k state at ``cand_cap`` 4096 and
  16384.

Each case's outputs from the two builds are held against each other
(``cd_pallas.compare_outputs``), then the two are timed in turns old,
new, new, old per round (CUDA events over 5 launches after a warm-up; a
new launch includes its work-item build and row merge), their host
time to enqueue a launch (the wall time of 20 launches without a
synchronisation; where it reaches the event time, the host sets the
pace) and their device time (the kernels and copies of 5 launches in a
``torch.profiler`` trace), and the new one once more at each ``--per-row`` count of work
items per row, with the peak memory that launch allocates.  Prints the
ms of every turn and the card's name, power limit, power draw, clocks
and temperature before and after.  Needs a CUDA device.
"""
import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
#: the C entry points of the one-CTA-per-row kernels at aa6415a
OLD_SIGNATURES = {
    "cd_full_grid_resume": [_p, _i, _i, _p, _p] + [_f] * 8 + [_p] * 7,
    "cd_cand_tiles": [_p, _i, _i, _p, _i] + [_f] * 8 + [_p] * 4,
}


def build_old(source):
    """Compile ``source`` like ``_cuda.build``; returns the loaded
    library."""
    from bluesky_tpu_torch.ops import _cuda
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    os.makedirs(_cuda.BUILD, exist_ok=True)
    out = os.path.join(_cuda.BUILD, f"libcd_tiles_ab_{digest}.so")
    res = subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH, *_cuda.FLAGS,
                          "-Xptxas", "-v", "-o", out, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    for line in res.stderr.splitlines():
        if re.search(r"entry function|Used \d+ registers|spill", line):
            print(f"old build: {line.strip()[:160]}")
    lib = ctypes.CDLL(out)
    for name, argtypes in OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def old_full_grid_resume(lib, x, reach_u8, p):
    from bluesky_tpu_torch.ops import _cuda, cd_pallas
    acc, ctin, cidx, keep, merged, active = cd_pallas.alloc_outputs(
        x.nb, 8, x.block, x.packed.device)
    rc = lib.cd_full_grid_resume(
        x.packed.data_ptr(), x.nb, x.block, reach_u8.data_ptr(),
        x.pold.data_ptr(), *cd_pallas.kernel_floats(p), acc.data_ptr(),
        ctin.data_ptr(), cidx.data_ptr(), keep.data_ptr(), merged.data_ptr(),
        active.data_ptr(), _cuda.stream_ptr(x.packed.device))
    _cuda.check(rc, "old cd_full_grid_resume")
    return list(acc.unbind(0)) + [ctin, cidx, keep, merged, active]


def old_cand_tiles(lib, x, cand, p):
    from bluesky_tpu_torch.ops import _cuda, cd_pallas
    acc, ctin, cidx = cd_pallas.alloc_outputs(x.nb, 8, x.block,
                                              x.packed.device, resume=False)
    rc = lib.cd_cand_tiles(
        x.packed.data_ptr(), x.nb, x.block, cand.data_ptr(), cand.shape[1],
        *cd_pallas.kernel_floats(p), acc.data_ptr(), ctin.data_ptr(),
        cidx.data_ptr(), _cuda.stream_ptr(x.packed.device))
    _cuda.check(rc, "old cd_cand_tiles")
    return list(acc.unbind(0)) + [ctin, cidx]


def operands(dev, backend, n, nmax):
    """The main path's next-interval operands of ``backend`` after
    ``chip_smoke.drive``: ``(x, p)`` for the sparse backend; for the
    pallas backend ``({cap: (x, cand, row_over)}, p)``, the operands and
    candidate tables at capacities 4096 and 16384."""
    import chip_smoke
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp
    state, cfg, _ = chip_smoke.drive(dev, backend, n, nmax)
    ac, a, c = state.ac, state.asas, cfg.asas
    mvp = cr_mvp.MVPConfig(rpz_m=c.rpz_m, hpz_m=c.hpz_m,
                           tlookahead=c.dtlookahead)
    if backend == "sparse":
        x = cd_sched.prepare(ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                             ac.gseast, ac.gsnorth, ac.active, a.noreso,
                             c.rpz, c.hpz, c.dtlookahead,
                             a.partners_s[:cd_sched.padded_size(nmax, 256)],
                             block=256, perm=a.sort_perm)
        return x, cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp,
                                        c.rpz * c.resofach)
    cols = [ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs, ac.gseast,
            ac.gsnorth, ac.active, a.noreso]
    cands = {cap: chip_smoke.pallas_operands(cols, a.sort_perm, dict(
        rpz=c.rpz, tlook=c.dtlookahead, cap=cap)) for cap in (4096, 16384)}
    return cands, cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp)


def clump(dev):
    """K2's operands where it has work: the second interval of the
    regional clump of ``chip_smoke.check_kernels`` (N=8,192, ``s_cap=2``),
    the partner table the first interval's.  Returns ``(x, p)``."""
    import chip_smoke
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp
    nm, ft = chip_smoke.NM, chip_smoke.FT
    mvp = cr_mvp.MVPConfig(rpz_m=5 * nm * 1.05, hpz_m=1000 * ft * 1.05,
                           tlookahead=300.0)
    p = cd_pallas.tile_params(5 * nm, 1000 * ft, 300.0, mvp, 5 * nm * 1.05)
    c = chip_smoke.columns(8192, "regional", seed=1)
    n_tot = cd_sched.padded_size(8192, 256)
    table = torch.full((n_tot, 8), -1, dtype=torch.int32, device=dev)
    x = None
    for t_ahead in (0.0, 20.0):
        x = cd_sched.prepare(*chip_smoke.cd_args(c, dev, t_ahead), 5 * nm,
                             1000 * ft, 300.0, table, block=256, s_cap=2,
                             perm=None if x is None else x.perm)
        table = cd_sched.run_kernels(x, p)[11].transpose(1, 2) \
            .reshape(n_tot, 8).contiguous()
    return x, p


def host_ms(fn, reps=20):
    """Host wall ms to enqueue one call of ``fn`` (no synchronisation
    inside the ``reps`` calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def device_ms(fn, reps=5):
    """Device ms of one call of ``fn``: the self time of every kernel
    and copy in a ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / reps / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_source")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--per-row", type=int, nargs="*", default=[])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nmax", type=int, default=100_352)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from bluesky_tpu_torch.ops import _cuda, cd_pallas
    dev = torch.device("cuda")
    old = build_old(args.old_source)
    _cuda.load("cd_tiles.cu")

    xc, pc = clump(dev)
    xs, ps = operands(dev, "sparse", args.n, args.nmax)
    cands, pp = operands(dev, "pallas", args.n, args.nmax)
    cases = {}
    for tag, x, p in (("clump", xc, pc), ("main path", xs, ps)):
        reach_f = x.reach & x.overflow[:, None]
        reach_u8 = reach_f.to(torch.uint8)
        print(f"K2 {tag}: {int(x.overflow.sum())} overflow rows, "
              f"{int(reach_f.sum())} tiles")
        cases[f"K2 full_grid_resume, {tag}"] = (
            lambda x=x, r=reach_u8, p=p: old_full_grid_resume(old, x, r, p),
            lambda c=None, x=x, r=reach_f, p=p: cd_pallas.full_grid_resume(
                x.packed, r, x.pold, p,
                per_row=c or cd_pallas.RESUME_ITEMS_PER_ROW))
    for cap, (x, cand, over) in cands.items():
        print(f"K4 cand_cap={cap}: {int(over.sum())} overflow rows of "
              f"{x.nb}, {int(cd_pallas.cand_items(cand, x.block, 1).length.sum())}"
              f" sub-chunks")
        cases[f"K4 cand_tiles, cand_cap={cap}"] = (
            lambda x=x, cand=cand: old_cand_tiles(old, x, cand, pp),
            lambda c=None, x=x, cand=cand: cd_pallas.cand_tiles(
                x.packed, cand, pp,
                per_row=c or cd_pallas.CAND_ITEMS_PER_ROW))

    chip_smoke.log_card("before the timings")
    for name, (run_old, run_new) in cases.items():
        err = cd_pallas.compare_outputs(f"{name} new vs old", run_new(),
                                        run_old())
        print(f"{name}: new equals old (max abs float difference {err:.3g})")
        for r in range(args.rounds):
            turns = [("old", run_old), ("new", run_new), ("new", run_new),
                     ("old", run_old)]
            ms = [(who, chip_smoke.cuda_ms(fn, 5)) for who, fn in turns]
            print(f"{name} round {r}: " + ", ".join(
                f"{who} {t:.4g} ms" for who, t in ms), flush=True)
        print(f"{name} per call: host enqueue old {host_ms(run_old):.4g} "
              f"ms, new {host_ms(run_new):.4g} ms; device old "
              f"{device_ms(run_old):.4g} ms, new {device_ms(run_new):.4g} ms",
              flush=True)
        for c in args.per_row:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = chip_smoke.cuda_ms(lambda: run_new(c), 5)
            peak = torch.cuda.max_memory_allocated() - base
            print(f"{name} new at {c} items per row: {t:.4g} ms, peak "
                  f"memory of the launch {peak / 2**20:.1f} MiB", flush=True)
    chip_smoke.log_card("after the timings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
