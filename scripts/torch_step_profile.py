#!/usr/bin/env python3
"""Where a chunk of the PyTorch/CUDA port's step spends its time on the
card: one 20-step chunk (sort refresh + ``run_steps``) of the main
path of ``chip_smoke.py`` (its ``main_scene``: 100,000 continental
aircraft, ``pair_matrix=False``) under ``torch.profiler``, after a
warm-up chunk, for the sparse, pallas or tiled CD backend (block 256,
256 and 512), or for the dense backend on ``regional_scene`` (pass
``--n 10000 --nmax 10240``; block 512, no sort refresh).

    python3 scripts/torch_step_profile.py [--n 100000] [--nmax 100352] \
        [--backend sparse|pallas|tiled|dense]

Prints the chunk's wall time, the summed device time of its kernels and
their share of the wall time (one stream, so the sum is the busy time),
the kernel-launch count, and the kernels with the most device time.
Needs a CUDA device.
"""
import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_us(evt):
    """Self device time of a profiler row [us] across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nmax", type=int, default=100_352)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--backend", choices=("sparse", "pallas", "tiled",
                                          "dense"), default="sparse")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from bluesky_tpu_torch.core import asas, step as stepmod
    from chip_smoke import main_scene, regional_scene

    n = args.n
    scene = regional_scene if args.backend == "dense" else main_scene
    block = 512 if args.backend in ("tiled", "dense") else 256
    state, cfg = scene(torch.device("cuda"), n, args.nmax,
                       cd_backend=args.backend, cd_block=block)

    def chunk(st):
        if args.backend != "dense":
            st = asas.refresh_spatial_sort(
                st, cfg.asas, block=block,
                impl=asas.impl_for_backend(args.backend))
        return stepmod.run_steps(st, cfg, args.steps)

    state = chunk(state)                            # warm-up (builds too)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = chunk(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if device_us(e) > 0]
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"{torch.cuda.get_device_name(0)}: N={n}, {args.backend}, "
          f"{args.steps}-step chunk "
          f"{wall_ms:.2f} ms wall, kernels {busy_ms:.2f} ms device "
          f"({100 * busy_ms / wall_ms:.1f}% busy), {launches} kernel "
          f"launches, ASAS intervals so far {float(state.asas_tnext):g}")
    for e in sorted(kernels, key=device_us, reverse=True)[:15]:
        print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
