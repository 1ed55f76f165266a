#!/usr/bin/env python3
"""K1 (``cd_sched_tiles``) and K3 (``cd_full_grid``) of
``bluesky_tpu_torch/csrc/cd_tiles.cu`` against an earlier build of that
source, in one process on one card, at the main path's shapes of
``chip_smoke.py``: 100,000 continental aircraft, each backend stepped
2 x 20 steps, then the next interval's operands.

    git show 663e2c0:bluesky_tpu_torch/csrc/cd_tiles.cu > old_cd_tiles.cu
    python3 scripts/torch_kernels_ab.py old_cd_tiles.cu [--rounds 2] \
        [--per-row 4 8 16]

The earlier source must have the one-CTA-per-row C interface of commit
663e2c0 (``cd_sched_tiles(packed, nb, B, wst, wln, S, wmax, pold, ...)``,
``cd_full_grid(packed, nb, B, reach, ...)``).  It is built with the flags
of ``ops/_cuda.py`` (its ``-Xptxas -v`` register lines are printed) into
``bluesky_tpu_torch/_build/``.  Each kernel's outputs from the two builds
are held against each other (``cd_pallas.compare_outputs``), then the
two are timed in turns old, new, new, old per round (CUDA events over 5
launches after a warm-up; a new launch includes its work-item build and
row merge), and the new ones once more at each ``--per-row`` count of
work items per row.  Prints the ms of every turn and the card's name and
power limit.  Needs a CUDA device.
"""
import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
#: the C entry points of the earlier interface
OLD_SIGNATURES = {
    "cd_sched_tiles": [_p, _i, _i, _p, _p, _i, _i, _p] + [_f] * 8 + [_p] * 7,
    "cd_full_grid": [_p, _i, _i, _p] + [_f] * 8 + [_p] * 4,
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


def old_sched_tiles(lib, x, p):
    from bluesky_tpu_torch.ops import _cuda, cd_pallas
    acc, ctin, cidx, keep, merged, active = cd_pallas.alloc_outputs(
        x.nb, 8, x.block, x.packed.device)
    rc = lib.cd_sched_tiles(
        x.packed.data_ptr(), x.nb, x.block, x.wst.data_ptr(),
        x.wln.data_ptr(), x.wst.shape[1], int(x.wmax), x.pold.data_ptr(),
        *cd_pallas.kernel_floats(p), acc.data_ptr(), ctin.data_ptr(),
        cidx.data_ptr(), keep.data_ptr(), merged.data_ptr(),
        active.data_ptr(), _cuda.stream_ptr(x.packed.device))
    _cuda.check(rc, "old cd_sched_tiles")
    return list(acc.unbind(0)) + [ctin, cidx, keep, merged, active]


def old_full_grid(lib, x, reach_u8, p):
    from bluesky_tpu_torch.ops import _cuda, cd_pallas
    acc, ctin, cidx = cd_pallas.alloc_outputs(x.nb, 8, x.block,
                                              x.packed.device, resume=False)
    rc = lib.cd_full_grid(
        x.packed.data_ptr(), x.nb, x.block, reach_u8.data_ptr(),
        *cd_pallas.kernel_floats(p), acc.data_ptr(), ctin.data_ptr(),
        cidx.data_ptr(), _cuda.stream_ptr(x.packed.device))
    _cuda.check(rc, "old cd_full_grid")
    return list(acc.unbind(0)) + [ctin, cidx]


def operands(dev, backend, n, nmax):
    """The main path's next-interval operands of ``backend`` after
    ``chip_smoke.drive``: ``(x, p)``."""
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
    x = chip_smoke.pallas_operands(cols, a.sort_perm, dict(
        rpz=c.rpz, tlook=c.dtlookahead, cap=chip_smoke.CAND_CAP))[0]
    return x, cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp)


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
    from bluesky_tpu_torch.ops import _cuda, cd_pallas, cd_sched
    dev = torch.device("cuda")
    old = build_old(args.old_source)
    _cuda.load("cd_tiles.cu")

    x, p = operands(dev, "sparse", args.n, args.nmax)
    xp, pp = operands(dev, "pallas", args.n, args.nmax)
    reach_u8 = xp.reach.to(torch.uint8).contiguous()
    pairs = {
        "K1 cd_sched_tiles": (
            lambda: old_sched_tiles(old, x, p),
            lambda c=cd_pallas.ITEMS_PER_ROW: cd_sched.sched_tiles(
                x.packed, x.wst, x.wln, x.wmax, x.pold, p, per_row=c)),
        "K3 cd_full_grid": (
            lambda: old_full_grid(old, xp, reach_u8, pp),
            lambda c=cd_pallas.ITEMS_PER_ROW: cd_pallas.full_grid(
                xp.packed, xp.reach, pp, per_row=c)),
    }
    for name, (run_old, run_new) in pairs.items():
        err = cd_pallas.compare_outputs(f"{name} new vs old", run_new(),
                                        run_old())
        print(f"{name}: new equals old (max abs float difference {err:.3g})")
        for r in range(args.rounds):
            turns = [("old", run_old), ("new", run_new), ("new", run_new),
                     ("old", run_old)]
            ms = [(who, chip_smoke.cuda_ms(fn, 5)) for who, fn in turns]
            print(f"{name} round {r}: " + ", ".join(
                f"{who} {t:.4g} ms" for who, t in ms), flush=True)
        for c in args.per_row:
            print(f"{name} new at {c} items per row: "
                  f"{chip_smoke.cuda_ms(lambda: run_new(c), 5):.4g} ms",
                  flush=True)
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
