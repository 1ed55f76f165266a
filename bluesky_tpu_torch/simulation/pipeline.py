"""Host-side view of one chunk edge's packed telemetry.

Port of ``bluesky_tpu/simulation/pipeline.py``.  The pipelined chunk
loop (``sim.py``) dispatches chunk k+1 before running chunk k's edge
subsystems; those subsystems must therefore read chunk k's values from
somewhere other than ``traf.state`` (whose tensors the next chunk
advances in place).  ``ChunkEdge`` wraps the ``EdgeTelemetry`` pack the
chunk runner returned (``core/step.py``), with the chunk's ScanStats,
refresh and fingerprint packs.

The pull to the host is the one place where the pipeline could
serialise without an error: a plain ``.cpu()`` on the compute stream
waits for everything enqueued on it, chunk k+1 included.  So the edge
enqueues the copy of every tensor of its packs into pinned host memory
(``non_blocking``) when it is made, right after its chunk and before the
next dispatch, and records a CUDA event behind the copies.  ``bad_step``
and ``fetch`` wait on that event alone: chunk k and its copies, never
chunk k+1.  The wait is the pipeline's completion fence, bounding it to
one chunk in flight.  On a CPU state the packs are the host arrays
already.

Observability: the chunk-sequence correlation tag lives here, on the
host edge object, not in the device pack; ``t_dispatch`` anchors the
chunk-latency series and ``fetch`` reports the edge pull's wall time to
the owning sim's ``sim_edge_pull_ms`` histogram through ``obs_sink``.
"""
import time
from typing import Optional

import numpy as np
import torch

from ..core.graph import leaves, rebuild


def _host_copy(tree):
    """``(host tree, event)``: ``tree`` with every tensor replaced by a
    NumPy array.  CUDA tensors are copied into pinned host memory on the
    current stream without waiting; ``event`` (None on the CPU) marks
    the end of the copies, and the arrays may be read only after it."""
    src = [t for _, t in leaves(tree)]
    if not any(t.is_cuda for t in src):
        return rebuild(tree, iter([t.numpy() for t in src])), None
    dst = []
    for t in src:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        dst.append(h)
    event = torch.cuda.Event()
    event.record()
    return rebuild(tree, iter([h.numpy() for h in dst])), event


class ChunkEdge:
    """One retired-or-pending chunk edge: telemetry + host bookkeeping."""

    def __init__(self, telemetry, chunk: int,
                 simt_planned: Optional[float] = None,
                 seq: int = -1, obs_sink=None, stats=None,
                 refresh=None, fingerprint=None):
        # The host copies of the telemetry and of the packs that rode
        # the chunk (each None when its flag was off), enqueued now.
        # ``stats``, ``refresh`` and ``fingerprint`` are set here, not
        # lazily: ``__getattr__`` forwards unknown names to the pack.
        host, self._event = _host_copy(dict(
            pack=telemetry, stats=stats, refresh=refresh,
            fingerprint=fingerprint))
        self._pack = host["pack"]
        self.stats = host["stats"]
        self.refresh = host["refresh"]
        self.fingerprint = host["fingerprint"]
        self.chunk = int(chunk)
        self._simt_planned = simt_planned
        self._ready = self._event is None
        self._bad = None
        self.seq = int(seq)
        self.t_dispatch = time.perf_counter()
        self._obs_sink = obs_sink

    def _wait(self):
        """Block until this edge's chunk and its host copies are done."""
        if not self._ready:
            t0 = time.perf_counter()
            self._event.synchronize()
            self._ready = True
            if self._obs_sink is not None:
                self._obs_sink((time.perf_counter() - t0) * 1e3)

    # ------------------------------------------------------------- fetch
    @property
    def bad_step(self) -> int:
        """First bad step index within the chunk (-1 clean): the
        deferred guard word.  Blocks until the producing chunk and its
        copies complete (the pipeline's completion fence)."""
        if self._bad is None:
            self._wait()
            self._bad = int(self._pack.bad)
        return self._bad

    def fetch(self):
        """The whole pack as host NumPy arrays."""
        self._wait()
        return self._pack

    # ------------------------------------------------------------ fields
    @property
    def simt(self) -> float:
        """Sim time at this edge: the host prediction when one was
        recorded at dispatch (no wait), else the device value."""
        if self._simt_planned is not None:
            return self._simt_planned
        return float(self.fetch().simt)

    def __getattr__(self, name):
        # telemetry field access (lat, lon, active, nconf_cur, ...)
        if name.startswith("_"):
            raise AttributeError(name)
        pack = self.fetch()
        try:
            return getattr(pack, name)
        except AttributeError:
            raise AttributeError(
                f"ChunkEdge has no field {name!r}") from None

    def acdata_arrays(self):
        """The ACDATA per-aircraft field dict (screenio stream), sliced
        by the live mask; one bulk fetch backs all of it."""
        pack = self.fetch()
        idx = np.flatnonzero(np.asarray(pack.active))
        data = {name: np.asarray(getattr(pack, name))[idx]
                for name in ("lat", "lon", "alt", "trk", "tas", "gs",
                             "cas", "vs", "inconf", "tcpamax", "asasn",
                             "asase")}
        return idx, data
