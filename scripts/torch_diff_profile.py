#!/usr/bin/env python3
"""Where the differentiable rollout's time goes (``bluesky_tpu_torch/diff``).

    python3 scripts/torch_diff_profile.py [--device cuda|cpu] [--n 50] \
        [--steps 100] [--chunk 50]

On ``conflict_scene(n, leg_km=20)`` in float32, ASAS out of the loop,
one rollout of ``steps`` steps of 1 s in chunks of ``chunk``: the ops
dispatched (counted by a ``TorchDispatchMode``, views and detaches
included) by the forward without a gradient and by one value and
gradient (``value_and_grad_once``), then, after a warm-up, the wall
seconds of each of three runs of the forward, of the value and gradient
through the checkpointed rollout, and of the same with plain autograd
(``torch.utils.checkpoint`` replaced by a direct call).  The card, when
used, is synchronised before each clock is read.
"""
import argparse
import collections
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=50)
    args = ap.parse_args()
    from bluesky_tpu_torch.diff import optimize as dopt
    from bluesky_tpu_torch.diff.objectives import ObjectiveWeights

    dev = torch.device(args.device)
    traf, acfg = dopt.conflict_scene(args.n, leg_km=20.0, device=dev)
    state = traf.state
    _, cfg = dopt._opt_config(acfg, 1.0, False, None)

    def forward():
        with torch.no_grad():
            return float(dopt._rollout(state, cfg, args.steps, args.chunk,
                                       ObjectiveWeights(), 1.0, False)[0])

    def value_and_grad():
        value, grads, bad = dopt.value_and_grad_once(
            state, acfg, tend=float(args.steps), chunk=args.chunk)
        return float(value) + float(sum(g.sum() for g in grads)) + int(bad)

    def timed(fn):
        out = []
        for _ in range(3):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out.append(round(time.perf_counter() - t0, 4))
        return out

    for name, fn in (("forward", forward), ("value and gradient",
                                            value_and_grad)):
        fn()
        with _Count() as c:
            fn()
        print(f"{name}: {sum(c.ops.values()) / args.steps:.1f} ops a step; "
              f"most dispatched {c.ops.most_common(6)}")
    print(f"forward s {timed(forward)}")
    print(f"value and gradient, checkpointed s {timed(value_and_grad)}")
    real = dopt.checkpoint
    dopt.checkpoint = lambda fn, *a, **kw: fn(*a)
    try:
        value_and_grad()
        print(f"value and gradient, plain autograd s {timed(value_and_grad)}")
    finally:
        dopt.checkpoint = real
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
