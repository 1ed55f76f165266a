#!/usr/bin/env python3
"""Two chunk timings of one tree of the repo, for A/B runs of two commits
on one card: the pallas worlds chunk of ``chip_smoke.py``'s worlds phase
(256 worlds x 500 aircraft in 512 slots, MVP) and the dense 10k graphed
chunk without CD (``regional_scene``, 20 steps of ``run_steps``), each
8 times after building the kernels; the first two chunks capture the
graphs and are dropped.

    python3 scripts/torch_ab_chunks.py <tree>

``tree`` is the root of a checkout (say the parent commit unpacked with
``git archive`` into a gitignored directory); run parent, change,
change, parent in one call and compare within it.
"""
import os
import sys
import time

import torch

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import chip_smoke as cs  # noqa: E402
from bluesky_tpu_torch.core import graph, step as stepmod  # noqa: E402
from bluesky_tpu_torch.ops import _cuda  # noqa: E402

assert cs.__file__.startswith(tree), cs.__file__
_cuda.build_all()
dev = torch.device("cuda")
out = {}
init, cfg = cs.world_scene(dev, 256, 500, 512, "pallas", "MVP")
state = init
ms = []
for _ in range(8):
    t0 = time.perf_counter()
    state = cs.world_chunk(state, cfg, "pallas")
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
out["worlds pallas 256x500 chunk ms"] = [round(m, 3) for m in ms[2:]]
graph.clear()
state, cfg = cs.regional_scene(dev)
cfg = cfg._replace(asas=cfg.asas._replace(swasas=False))
ms = []
for _ in range(8):
    t0 = time.perf_counter()
    state = stepmod.run_steps(state, cfg, 20)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
out["dense 10k graphed chunk without CD ms"] = [round(m, 3) for m in ms[2:]]
print(tree, out, flush=True)
