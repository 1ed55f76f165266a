"""Several processes on ``torch.distributed``: the job, shard ownership
and the joins of the shard results.

After ``join_job`` (``sharding.init_multihost``) every process of the
job runs the same program on the whole replicated state (SPMD).  A mesh
(``sharding.Mesh``) names the rank that owns each shard; each process
walks only its own shards and the joins gather every shard's results to
every rank (``allgather_shards``), so the rest of the step sees the same
shard-ordered results as on a single-process mesh.

The joins are all-gathers of equal-size tensors followed by local
concatenations and sums in shard order: the gathered bytes are the
shards' own results, never a reduction whose order the transport picks,
so a mesh spanning processes stays bit-equal to its single-device
reference.  Gloo has no all-gather for CUDA tensors: with the ``gloo``
backend and a CUDA shard the join stages through pinned host memory
(``JOINS["staged_bytes"]`` counts it), which the job's log line at
``join_job`` names.
"""
import datetime
import logging

import torch

log = logging.getLogger(__name__)

#: the job-wide view ``join_job`` sets: every rank's devices in rank
#: order, the rank of each, the backend and whether CUDA joins stage
#: through host memory
JOB = dict(devices=None, ranks=None, backend=None, staged=False)

#: this rank's join traffic: collectives, bytes received from its peers,
#: bytes staged through host memory (gloo with CUDA shards)
JOINS = dict(calls=0, bytes=0, staged_bytes=0)


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's rank in the job (0 outside a job)."""
    d = _dist()
    return d.get_rank() if d is not None else 0


def process_count() -> int:
    """The number of processes in the job (1 outside a job)."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def local_devices(device) -> list:
    """This process's devices for a job on ``device``: every visible GPU
    for a CUDA device, the one CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def join_job(coordinator_address, num_processes, process_id, device,
             backend=None, timeout_s=1800.0):
    """``torch.distributed.init_process_group`` over ``tcp://``
    ``coordinator_address`` ("host:port"), then the job-wide device table
    (every rank's ``local_devices`` in rank order).  The backend is
    ``nccl`` for a CUDA device and ``gloo`` for the CPU unless given
    (``gloo`` with CUDA tensors lets two ranks share one card, which
    NCCL refuses).  ``timeout_s`` is the process group's own collective
    timeout."""
    import torch.distributed as dist
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    mine = [str(d) for d in local_devices(device)]
    table = [None] * int(num_processes)
    dist.all_gather_object(table, mine)
    JOB.update(devices=[torch.device(d) for devs in table for d in devs],
               ranks=[r for r, devs in enumerate(table) for _ in devs],
               backend=backend,
               staged=backend == "gloo" and device.type == "cuda")
    log.info("rank %d of %d joined on %s, backend %s%s", process_id,
             num_processes, device, backend,
             ", CUDA joins staged through pinned host memory"
             if JOB["staged"] else "")
    return JOB


def leave_job():
    """Destroy the process group (a no-op outside a job)."""
    d = _dist()
    if d is not None:
        d.destroy_process_group()
    JOB.update(devices=None, ranks=None, backend=None, staged=False)


def spans_ranks(ranks) -> bool:
    """Whether shards with these owners need collectives: some shard
    belongs to another process.  A mesh that spans processes must span
    every process of the job (the joins run on the whole job)."""
    me = process_index()
    others = {int(r) for r in ranks} - {me}
    if not others:
        return False
    if len({int(r) for r in ranks}) != process_count():
        raise ValueError(f"a mesh over ranks {sorted(set(ranks))} must "
                         f"span all {process_count()} processes of the job")
    return True


def _collective(start, guard):
    """Start an async collective (``start()`` returns its ``Work``) and
    wait for it: through ``guard.guarded_ready`` (the MeshGuard's
    heartbeat-stamped timeout) when the mesh has one, which also decides
    a collective that fails as it starts (``guard.failed``)."""
    if guard is None:
        start().wait()
        return
    try:
        work = start()
    except Exception as e:  # noqa: BLE001 — a dead peer's transport error
        guard.failed(e)
    guard.guarded_ready(work)


def allgather_shards(local: dict, ranks, home, guard=None) -> dict:
    """Every shard's tensors on ``home``, in every process: ``local``
    maps each shard this rank owns to its list of tensors (every shard's
    list the same shapes and dtypes); the result maps every shard index
    to its list.  One all-gather of a byte buffer per call: each rank's
    shards packed in shard order and zero-padded to the most shards any
    rank owns.  Outside a multi-process mesh ``local`` comes back as it
    is."""
    ranks = [int(r) for r in ranks]
    if not spans_ranks(ranks):
        return dict(local)
    dist = _dist()
    me, world = process_index(), process_count()
    owned = [[d for d, r in enumerate(ranks) if r == q]
             for q in range(world)]
    m = max(len(o) for o in owned)
    like = local[owned[me][0]]
    sizes = [t.numel() * t.element_size() for t in like]
    width = sum(sizes)
    stage = home.type == "cuda" and JOB["backend"] == "gloo"
    buf_dev = torch.device("cpu") if stage else home
    new = lambda: torch.zeros((m, width), dtype=torch.uint8, device=buf_dev,
                              pin_memory=stage)
    buf = new()
    for i, d in enumerate(owned[me]):
        buf[i] = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                            for t in local[d]]).to(buf_dev)
    got = [new() for _ in range(world)]
    _collective(lambda: dist.all_gather(got, buf, async_op=True), guard)
    JOINS["calls"] += 1
    JOINS["bytes"] += (world - 1) * m * width
    if stage:
        JOINS["staged_bytes"] += (world + 1) * m * width
    out = dict(local)
    for q in range(world):
        if q == me:
            continue
        rows = got[q].to(home, non_blocking=False) if stage else got[q]
        for i, d in enumerate(owned[q]):
            ts, off = [], 0
            for t, nb in zip(like, sizes):
                ts.append(rows[i, off:off + nb].clone().view(t.dtype)
                          .reshape(t.shape))
                off += nb
            out[d] = ts
    return out


def allgather_words(word: int, guard=None) -> list:
    """One 64-bit integer from every rank, in rank order."""
    dist = _dist()
    if dist is None:
        return [int(word)]
    dev = torch.device("cuda") if JOB["backend"] == "nccl" \
        else torch.device("cpu")
    t = torch.tensor([int(word)], dtype=torch.int64, device=dev)
    got = [torch.empty_like(t) for _ in range(process_count())]
    _collective(lambda: dist.all_gather(got, t, async_op=True), guard)
    return [int(g.item()) for g in got]
