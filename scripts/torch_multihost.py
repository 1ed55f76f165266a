#!/usr/bin/env python3
"""One rank of a job of several processes that steps one replicated
state on a mesh spanning the ranks (``parallel/sharding.init_multihost``).

    python3 scripts/torch_multihost.py --rank R --world W --port P \
        --state in.npz --out DIR [--device cpu|cuda] [--backend gloo|nccl] \
        [--mode replicate[,pallas][,spatial][,tiles]] [--shards 4] \
        [--steps 20] [--chunks 3] [--block 256] \
        [--hb DIR --timeout S --hb-timeout S --resume-chunks N]

Every rank loads the same state (an ``.npz`` of
``core/state.state_to_numpy``) and, for each mode of ``--mode`` in turn,
enters the mode on a mesh of ``--shards`` shards of its device (a 2 x
S / 2 tile mesh in the tiles mode), rank r owning the r-th contiguous
run of S / W shards, and runs ``--chunks`` chunks of ``--steps`` steps
through ``sharding.sharded_step_fn``, whose
chunk edges compare the state's fingerprint across the ranks.  Rank r
writes ``rank<r>-<mode>.npz`` (the final state) and ``rank<r>.json``
(for each mode each chunk's wall ms, the join bytes it received from its
peers and staged through host memory and the collectives; the backend;
the kernel launches of its process) into ``--out``.

With ``--hb`` (the killed-peer case) the ranks step until one dies:
each waits on its joins through a ``MeshGuard`` (heartbeat stamps in the
``--hb`` directory, ``--timeout`` the collective budget, ``--hb-timeout``
the staleness budget) and after every chunk rank 0 writes the state to
``snap.npz`` and the chunk count to ``progress``.  On ``MeshLostError``
rank 0 writes ``meshlost.json`` (the message, the lost ranks, the wall
time, the wall ms of each guarded chunk it finished: the step and the
guard's wait, not the snapshot), resumes from the last ``snap.npz`` on
its own shards as a single-process mesh for ``--resume-chunks`` chunks
and writes ``resumed.npz``; it leaves without tearing down the broken
process group.  A rank exits 0 when it wrote what its case asks for.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_mesh(mode, device, shards, world):
    """The mesh of ``mode``: ``shards`` shards of ``device``, rank r owning
    the r-th contiguous run of ``shards / world``; a ``2 x shards / 2``
    tile mesh in the tiles mode."""
    from bluesky_tpu_torch.parallel import sharding
    per = shards // world
    devices = [device] * shards
    ranks = [d // per for d in range(shards)]
    if mode == "tiles":
        return sharding.make_tile_mesh((2, shards // 2), devices=devices,
                                       ranks=ranks)
    return sharding.make_mesh(devices=devices, ranks=ranks)


def enter(state, mesh, mode, block=256):
    """The state and config of ``mode`` on ``mesh``: ``replicate``,
    ``spatial`` or ``tiles`` of the sparse backend, or ``pallas`` (the
    pallas backend's replicate mode)."""
    from bluesky_tpu_torch.core.step import SimConfig
    from bluesky_tpu_torch.parallel import sharding
    cfg = SimConfig(cd_backend="pallas" if mode == "pallas" else "sparse",
                    cd_block=block)
    if mode == "spatial":
        state, _, info = sharding.prepare_spatial(state, mesh, cfg.asas,
                                                  block=block)
        cfg = cfg._replace(cd_shard_mode="spatial",
                           cd_halo_blocks=info["halo_blocks"])
    elif mode == "tiles":
        state, _, info = sharding.prepare_tiles(state, mesh, cfg.asas,
                                                block=block)
        cfg = cfg._replace(cd_shard_mode="tiles",
                           cd_tile_shape=tuple(info["tile_shape"]),
                           cd_tile_budgets=tuple(info["budgets"]))
    elif mode not in ("replicate", "pallas"):
        raise ValueError(f"unknown mode {mode!r}")
    return state, cfg


def save(path, state):
    from bluesky_tpu_torch.core.state import state_to_numpy
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state_to_numpy(state))
    os.replace(tmp, path)


def load(path, device):
    from bluesky_tpu_torch.core.state import state_from_numpy
    with np.load(path) as z:
        return state_from_numpy({k: z[k] for k in z.files}, device=device)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--state", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--mode", default="replicate")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--hb", default="")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--hb-timeout", type=float, default=2.0)
    ap.add_argument("--resume-chunks", type=int, default=3)
    args = ap.parse_args()

    import torch
    from bluesky_tpu_torch.parallel import dist, sharding
    if args.device == "cpu":
        torch.set_num_threads(1)
    device = torch.device(args.device)
    sharding.init_multihost(f"127.0.0.1:{args.port}", args.world, args.rank,
                            backend=args.backend, device=device,
                            timeout=args.timeout + args.hb_timeout + 60.0)
    if args.hb:
        mesh = make_mesh(args.mode, device, args.shards, args.world)
        state, cfg = enter(load(args.state, device), mesh, args.mode,
                           args.block)
        return killed_peer(state, cfg, mesh, device, args)
    tag = os.path.join(args.out, f"rank{args.rank}")
    rows = {}
    for mode in args.mode.split(","):
        mesh = make_mesh(mode, device, args.shards, args.world)
        state, cfg = enter(load(args.state, device), mesh, mode,
                           args.block)
        run = sharding.sharded_step_fn(mesh, cfg, nsteps=args.steps)
        rows[mode] = []
        for _ in range(args.chunks):
            before = dict(dist.JOINS)
            sync(device)
            t0 = time.perf_counter()
            state = run(state)
            sync(device)
            rows[mode].append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                **{k: dist.JOINS[k] - before[k] for k in before}))
        save(f"{tag}-{mode}.npz", state)
    from bluesky_tpu_torch.ops import cd_pallas, cd_sched
    with open(tag + ".json", "w") as f:
        json.dump(dict(chunks=rows, backend=dist.JOB["backend"],
                       staged=dist.JOB["staged"],
                       ranks=mesh.ranks.ravel().tolist(), device=str(device),
                       launches=dict(cd_pallas.LAUNCHES,
                                     **cd_sched.LAUNCHES)), f)
    # every rank stays in the job until all have written
    dist.allgather_words(0)
    dist.leave_job()
    return 0


def killed_peer(state, cfg, mesh, device, args):
    """Step until a peer dies; rank 0 then resumes from its last
    snapshot on its own shards (module docstring)."""
    from bluesky_tpu_torch.parallel import sharding
    from bluesky_tpu_torch.parallel.sharding import MeshGuard, MeshLostError
    guard = MeshGuard(mesh=mesh, heartbeat_dir=args.hb,
                      timeout=args.timeout, hb_timeout=args.hb_timeout)
    guard.stamp()
    run = sharding.sharded_step_fn(mesh, cfg, nsteps=args.steps)
    chunk, ms = 0, []
    try:
        while True:
            t0 = time.perf_counter()
            state = run(state)
            guard.guarded_ready(state)
            ms.append((time.perf_counter() - t0) * 1e3)
            chunk += 1
            if args.rank == 0:
                save(os.path.join(args.out, "snap.npz"), state)
                with open(os.path.join(args.out, "progress"), "w") as f:
                    f.write(f"{chunk}\n")
    except MeshLostError as e:
        t_lost = time.time()
        if args.rank != 0:
            raise
        with open(os.path.join(args.out, "meshlost.json"), "w") as f:
            json.dump(dict(error=str(e), lost=list(e.lost_groups),
                           survivors=[str(d) for d in e.survivors],
                           time=t_lost, chunks=chunk, ms=ms), f)
        small = sharding.make_mesh(devices=e.survivors)
        state = load(os.path.join(args.out, "snap.npz"), device)
        state, cfg = enter(state, small, args.mode, args.block)
        run = sharding.sharded_step_fn(small, cfg, nsteps=args.steps)
        for _ in range(args.resume_chunks):
            state = run(state)
        sync(device)
        save(os.path.join(args.out, "resumed.npz"), state)
        sys.stdout.flush()
        os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
