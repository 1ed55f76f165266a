#!/usr/bin/env python3
"""The MVP forms of the four kernels of ``bluesky_tpu_torch/csrc/cd_tiles.cu``
against the same kernels of an earlier source, in one process on one
card:

    mkdir -p _chipcheck
    git show 86cb929:bluesky_tpu_torch/csrc/cd_tiles.cu \\
        > _chipcheck/parent_cd_tiles.cu
    python3 scripts/torch_kernels_ab.py _chipcheck/parent_cd_tiles.cu \\
        [--rounds 3]

The earlier source must have the C interface of 86cb929, the walker
with its resolver forms and the partner width K before the mesh forms
(``PARENT_SIGNATURES``: the entry points without the mesh arguments), or
the interface with the mesh arguments (``_cuda.SIGNATURES``; told apart
by its ``rstride`` argument), so any commit from 86cb929 on serves as
the parent; its tables are 8 wide here.  It is built with the flags of
``ops/_cuda.py`` (its ``-Xptxas -v`` register lines are printed) into
``bluesky_tpu_torch/_build/``.  Both builds walk the same work items
(``cd_mask_items`` and ``window_items`` of the current source).  The
cases, at the main path's shapes:

* K1 (``cd_sched_tiles``) and K2 (``cd_sched_tiles`` on the overflow
  rows): 100,000 continental aircraft, the sparse backend stepped 2 x 20
  steps, the next interval's operands; K2 also on the regional clump of
  ``chip_smoke.check_kernels`` (N=8,192, ``s_cap=2``, the second
  interval), where it has overflow rows;
* K3 (``cd_full_grid``) and K4 (``cd_cand_items`` at ``cand_cap=4096``)
  on the pallas backend's stepped 100k state.

Each case's outputs from the two builds are held against each other
(``cd_pallas.compare_outputs``), then the two are timed in turns parent,
change, change, parent per round (CUDA events over 5 launches after a
warm-up; a launch of either build includes the same work-item build and
its row merge).  Prints
the ms of every turn and the card's name, power limit, power draw,
clocks and temperature before and after.  Needs a CUDA device.
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

_f, _d, _i, _p = ctypes.c_float, ctypes.c_double, ctypes.c_int, \
    ctypes.c_void_p
#: the C entry points of the walkers and the merge at 86cb929
PARENT_SIGNATURES = {
    "cd_sched_tiles": [_p, _i, _i, _p, _i, _p, _p, _p, _i, _p]
    + [_f] * 8 + [_d] * 2 + [_i, _i] + [_p] * 5,
    "cd_full_grid": [_p, _i, _i, _p, _i, _p, _p, _p, _i] + [_f] * 8
    + [_d] * 2 + [_i, _i] + [_p] * 4,
    "cd_cand_items": [_p, _i, _i, _p, _i, _p, _p, _p, _i, _p, _i]
    + [_f] * 8 + [_d] * 2 + [_i, _i] + [_p] * 4,
    "cd_merge_items": [_i, _i, _i, _i] + [_p] * 12 + [_i, _p],
}


def build_parent(source):
    """Compile ``source`` like ``_cuda.build``; returns the loaded
    library, with ``mesh`` True when its walkers take the mesh
    arguments."""
    from bluesky_tpu_torch.ops import _cuda
    with open(source, "rb") as fh:
        text = fh.read()
        digest = hashlib.sha256(text).hexdigest()[:12]
    mesh = b"int rstride" in text
    os.makedirs(_cuda.BUILD, exist_ok=True)
    out = os.path.join(_cuda.BUILD, f"libcd_tiles_ab_{digest}.so")
    res = subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH, *_cuda.FLAGS,
                          "-Xptxas", "-v", "-o", out, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    for line in res.stderr.splitlines():
        if re.search(r"entry function|Used \d+ registers|spill", line):
            print(f"parent build: {line.strip()[:160]}")
    lib = ctypes.CDLL(out)
    sigs = _cuda.SIGNATURES["cd_tiles.cu"] if mesh else PARENT_SIGNATURES
    for name in PARENT_SIGNATURES:
        getattr(lib, name).argtypes = sigs[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.mesh = mesh
    return lib


def parent_pass(lib, x, make_items, p, pold=None, cand=None):
    """One launch of the parent's walker on the work items that
    ``make_items()`` builds (each call builds them, as the current
    wrappers do) and its row merge: the outputs of
    ``cd_pallas.merge_items`` (MVP form)."""
    from bluesky_tpu_torch.ops import _cuda, cd_pallas
    items = make_items()
    nb, _, B = x.packed.shape
    C, W = items.length.shape[1], items.tiles.shape[1]
    G, dev = nb * C, x.packed.device
    acc = torch.empty((8, G, B), dtype=torch.float32, device=dev)
    ct = torch.empty((8, G, B), dtype=torch.float32, device=dev)
    ci = torch.empty((8, G, B), dtype=torch.int32, device=dev)
    keep = torch.empty((G, B), dtype=torch.int32, device=dev)
    head = (x.packed.data_ptr(), nb, B, items.tiles.data_ptr(), W,
            items.start.data_ptr(), items.length.data_ptr(),
            items.order.data_ptr(), C)
    floats = (*cd_pallas.kernel_floats(p), cd_pallas.RESO_CODE["mvp"], 8)
    stream = _cuda.stream_ptr(dev)
    mform = (0, 0, 1, 0, 0) if lib.mesh else ()   # the single-device form
    if cand is not None:
        rc = lib.cd_cand_items(*head, cand.data_ptr(), cand.shape[1],
                               *floats, acc.data_ptr(), ct.data_ptr(),
                               ci.data_ptr(), stream)
    elif pold is None:
        rc = lib.cd_full_grid(*head, *floats, acc.data_ptr(), ct.data_ptr(),
                              ci.data_ptr(), *mform, stream)
    else:
        rc = lib.cd_sched_tiles(*head, pold.data_ptr(), *floats,
                                acc.data_ptr(), ct.data_ptr(), ci.data_ptr(),
                                keep.data_ptr(), *mform, stream)
    _cuda.check(rc, "parent walker")
    outs = cd_pallas.alloc_outputs(nb, 8, B, dev, resume=pold is not None)
    ptrs = [t.data_ptr() for t in outs] + [0] * (6 - len(outs))
    rc = lib.cd_merge_items(
        nb, B, C, 8, items.length.data_ptr(),
        0 if pold is None else pold.data_ptr(), acc.data_ptr(),
        ct.data_ptr(), ci.data_ptr(), 0 if pold is None else keep.data_ptr(),
        *ptrs, cd_pallas.RESO_CODE["mvp"], stream)
    _cuda.check(rc, "parent cd_merge_items")
    return list(outs[0].unbind(0)) + list(outs[1:])


def operands(dev, backend, n, nmax):
    """The main path's next-interval operands of ``backend`` after
    ``chip_smoke.drive``: ``(x, p)`` for the sparse backend; for the
    pallas backend ``((x, cand), p)`` with the candidate table at 4096."""
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
    x, cand, _ = chip_smoke.pallas_operands(cols, a.sort_perm, dict(
        rpz=c.rpz, tlook=c.dtlookahead, cap=4096))
    return (x, cand), cd_pallas.tile_params(c.rpz, c.hpz, c.dtlookahead, mvp)


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_source")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nmax", type=int, default=100_352)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from bluesky_tpu_torch.ops import _cuda, cd_pallas, cd_sched
    dev = torch.device("cuda")
    parent = build_parent(args.parent_source)
    _cuda.load("cd_tiles.cu")

    xs, ps = operands(dev, "sparse", args.n, args.nmax)
    (xp, cand), pp = operands(dev, "pallas", args.n, args.nmax)
    xc, pc = clump(dev)
    cases = {}
    items1 = lambda: cd_sched.window_items(xs.wst, xs.wln, xs.wmax, xs.nb)
    cases["K1 sched_tiles, main path"] = (
        lambda: parent_pass(parent, xs, items1, ps, pold=xs.pold),
        lambda: cd_sched.sched_tiles(xs.packed, xs.wst, xs.wln, xs.wmax,
                                     xs.pold, ps))
    for tag, x, p in (("main path", xs, ps), ("clump", xc, pc)):
        reach_f = x.reach & x.overflow[:, None]
        items2 = lambda r=reach_f: cd_pallas.reach_items(
            r, cd_pallas.RESUME_ITEMS_PER_ROW)
        print(f"K2 {tag}: {int(x.overflow.sum())} overflow rows, "
              f"{int(reach_f.sum())} tiles")
        cases[f"K2 full_grid_resume, {tag}"] = (
            lambda x=x, r=reach_f, p=p, it=items2: parent_pass(
                parent, x, it, p, pold=x.pold),
            lambda x=x, r=reach_f, p=p: cd_pallas.full_grid_resume(
                x.packed, r, x.pold, p))
    items3 = lambda: cd_pallas.reach_items(xp.reach)
    cases["K3 full_grid, main path"] = (
        lambda: parent_pass(parent, xp, items3, pp),
        lambda: cd_pallas.full_grid(xp.packed, xp.reach, pp))
    items4 = lambda: cd_pallas.cand_items(cand, xp.block)
    cases["K4 cand_tiles, cand_cap=4096"] = (
        lambda: parent_pass(parent, xp, items4, pp, cand=cand),
        lambda: cd_pallas.cand_tiles(xp.packed, cand, pp))

    chip_smoke.log_card("before the timings")
    for name, (run_parent, run_change) in cases.items():
        err = cd_pallas.compare_outputs(f"{name} change vs parent",
                                        run_change(), run_parent())
        print(f"{name}: change equals parent (max abs float difference "
              f"{err:.3g})")
        for r in range(args.rounds):
            turns = [("parent", run_parent), ("change", run_change),
                     ("change", run_change), ("parent", run_parent)]
            ms = [(who, chip_smoke.cuda_ms(fn, 5)) for who, fn in turns]
            print(f"{name} round {r}: " + ", ".join(
                f"{who} {t:.4g} ms" for who, t in ms), flush=True)
    chip_smoke.log_card("after the timings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
