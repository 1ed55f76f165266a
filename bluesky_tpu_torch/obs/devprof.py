"""Device-level observability: compile telemetry, memory watermarks,
donation accounting and on-demand device-trace windows (the port of
``bluesky_tpu/obs/devprof.py`` on ``torch.profiler``).

The counters, gauges and histograms keep the JAX package's names, which
the server's HEALTH and the mitigator read from the workers' heartbeats
(``network/server.py``, ``network/mitigate.py``).  What each names in
the port:

* **A "compile"** is a CUDA-graph capture of a chunk's step
  (``core/graph._capture``) or an ``nvcc`` build of a kernel source
  (``ops/_cuda``).  Both report their wall time through
  ``compile_event`` to every subscribed registry, the way JAX's
  ``jax.monitoring`` listener does: ``devprof_compile_trace_ms`` the
  capture's warm-up step (the eager run that records nothing),
  ``devprof_compile_lower_ms`` the capture itself, and
  ``devprof_compile_backend_ms`` a build, each also counted in
  ``devprof_backend_compiles``.  The host-side cache accounting
  (``note_dispatch``) takes the graph pool's own answer: a chunk
  dispatch that made a new executor (``core/graph.misses`` rose: a new
  key, or a state that holds no executor's buffers) is a miss, split
  into *ladder warm-up* (the chunk length on the Simulation's
  ``CHUNK_LADDER``) and *off-ladder*; any other dispatch is a hit.

* **Memory**: ``sample_memory`` reads, per device of the state, the
  caching allocator's ``torch.cuda.memory_allocated`` and
  ``max_memory_allocated`` on the card (host counters: no sync), and on
  the CPU the bytes of the state's tensors, into
  ``devprof_live_bytes_dev<i>``, ``devprof_peak_bytes_dev<i>`` and
  ``devprof_live_bytes_total``; throttled by ``devprof_mem_dt``.

* **PROFILE DEVICE [n] [dir]** opens a ``torch.profiler`` window over the
  next ``n`` chunk dispatches (CPU and, on the card, CUDA activity); each
  windowed chunk is fenced (``torch.cuda.synchronize``) and timed in
  three parts, *compute* (dispatch to device done), *halo* (the
  pre-dispatch sort or shard refresh) and *edge* (the host edge
  retirement), sent as ``devprof_chunk`` events to the flight recorder
  and into three histograms; the window closes after the ``n``-th edge
  as a ``device_profile`` span tagged with the directory, where the
  Chrome trace (``devprof-<seq>.json``) is written.

Contract (JAX ``obs/devprof.py``): with every feature off the hooks are
attribute checks and host bookkeeping only: no device op and no host
sync, and the stepped state is bit-equal.
"""
import os
import threading
import time
import weakref

import torch

#: compile-event kinds (``compile_event``) -> histogram series, in ms
_COMPILE_EVENTS = {
    "capture_warmup": "devprof_compile_trace_ms",
    "capture": "devprof_compile_lower_ms",
    "build": "devprof_compile_backend_ms",
}

COMPILE_MS_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

_SUBSCRIBERS = weakref.WeakSet()     # registries fed by compile_event
_LOCK = threading.Lock()


def install_compile_listener(registry):
    """Subscribe ``registry`` to the process's compile events (captures
    and builds); dead Simulations drop out of the weak set on their
    own.  Returns True, as JAX's does when its monitoring API exists."""
    with _LOCK:
        _SUBSCRIBERS.add(registry)
    return True


def compile_event(kind, ms):
    """Report one compile of ``kind`` (``_COMPILE_EVENTS``) taking ``ms``
    wall milliseconds to every subscribed registry."""
    name = _COMPILE_EVENTS[kind]
    with _LOCK:
        regs = list(_SUBSCRIBERS)
    for reg in regs:
        reg.histogram(name, buckets=COMPILE_MS_BUCKETS).observe(ms)
        if kind != "capture_warmup":
            reg.counter("devprof_backend_compiles").inc()


def _state_tensors(state):
    """Every tensor of a state (any dataclass, NamedTuple or dict of
    tensors), each storage once."""
    from ..core.graph import leaves
    seen, out = set(), []
    for _, t in leaves(state):
        key = (t.device, t.untyped_storage().data_ptr())
        if t.numel() and key not in seen:
            seen.add(key)
            out.append(t)
    return out


def _device_id(dev):
    return 0 if dev.index is None else int(dev.index)


class DevProf:
    """Per-Simulation device observability (``sim.devprof``).  Every hook
    returns on attribute checks when its feature is off.  ``state_fn``
    gives the Simulation's current state (the memory sample's CPU bytes
    and its devices)."""

    def __init__(self, obs, recorder, ladder=(), state_fn=None):
        self.obs = obs
        self.recorder = recorder
        self.ladder = tuple(int(x) for x in ladder)
        self.state_fn = state_fn
        self._peaks = {}             # device id -> peak bytes seen
        self._last_mem = -1e18       # monotonic stamp of the last sample
        self._window = None          # the open profile window
        self._window_req = None      # (n_chunks, logdir) armed
        self.windows = []            # closed-window records
        from .. import settings
        if bool(getattr(settings, "devprof_compile_telemetry", True)):
            install_compile_listener(obs)
        obs.counter("devprof_cache_hits",
                    help="chunk dispatches whose graph key was already "
                         "captured")
        obs.counter("devprof_cache_misses_ladder",
                    help="first-seen dispatch keys with nsteps on the "
                         "chunk ladder (expected warm-up captures)")
        obs.counter("devprof_cache_misses_offladder",
                    help="first-seen dispatch keys OFF the chunk ladder "
                         "(mid-run recaptures)")

    # ------------------------------------------------ compile telemetry
    def note_dispatch(self, program, nsteps, nmax, ndev, miss):
        """The cache accounting of one chunk dispatch: a ``miss`` (the
        dispatch made a new chunk executor) on the ladder or off it, else
        a hit."""
        from .. import settings
        if not bool(getattr(settings, "devprof_compile_telemetry", True)):
            return
        if not miss:
            self.obs.get("devprof_cache_hits").inc()
        elif int(nsteps) in self.ladder:
            self.obs.get("devprof_cache_misses_ladder").inc()
        else:
            self.obs.get("devprof_cache_misses_offladder").inc()
            self.recorder.instant("devprof_recompile", cat="devprof",
                                  program=program, nsteps=int(nsteps),
                                  nmax=int(nmax), ndev=int(ndev))

    def compile_summary(self):
        """One line of HEALTH and METRICS: the cache accounting."""
        g = lambda n: int(getattr(self.obs.get(n), "value", 0) or 0)
        bc = self.obs.get("devprof_backend_compiles")
        parts = [f"ladder warm-up {g('devprof_cache_misses_ladder')}",
                 f"off-ladder {g('devprof_cache_misses_offladder')}",
                 f"hits {g('devprof_cache_hits')}"]
        if bc is not None:
            parts.append(f"backend compiles {int(bc.value)}")
        return ", ".join(parts)

    # ------------------------------------------------ memory watermarks
    def _live_bytes(self):
        """``({device id: bytes}, {device id: CUDA device})``: the
        allocator's live bytes of each CUDA device of the state, the
        state's tensor bytes on the CPU."""
        per, cuda = {}, {}
        state = self.state_fn() if self.state_fn is not None else None
        for t in ([] if state is None else _state_tensors(state)):
            did = _device_id(t.device)
            if t.device.type == "cuda":
                cuda[did] = t.device
            else:
                per[did] = per.get(did, 0) + t.untyped_storage().nbytes()
        for did, dev in cuda.items():
            per[did] = int(torch.cuda.memory_allocated(dev))
        return per, cuda

    def sample_memory(self, now=None, force=False):
        """Per-device live and peak byte gauges (throttled by the
        ``devprof_mem_dt`` knob; 0 = off).  Returns ``{device id: live
        bytes}``, or None when skipped."""
        from .. import settings
        dt = float(getattr(settings, "devprof_mem_dt", 0.0))
        if dt <= 0.0 and not force:
            return None
        now = time.monotonic() if now is None else now
        if not force and now - self._last_mem < dt:
            return None
        self._last_mem = now
        per, cuda = self._live_bytes()
        total = 0
        for did, nbytes in sorted(per.items()):
            total += nbytes
            peak = max(self._peaks.get(did, 0), nbytes)
            dev = cuda.get(did)
            if dev is not None:
                # the allocator's own peak sees the transients between
                # samples
                peak = max(peak, int(torch.cuda.max_memory_allocated(dev)))
            self._peaks[did] = peak
            self.obs.gauge(f"devprof_live_bytes_dev{did}",
                           help="live device bytes at the last chunk-edge "
                                "sample").set(nbytes)
            self.obs.gauge(f"devprof_peak_bytes_dev{did}",
                           help="peak live device bytes seen").set(peak)
        self.obs.gauge("devprof_live_bytes_total",
                       help="live device bytes, all devices").set(total)
        return per

    def watermarks(self):
        """``{device id: (live, peak)}`` of the last sample."""
        out = {}
        for did, peak in sorted(self._peaks.items()):
            g = self.obs.get(f"devprof_live_bytes_dev{did}")
            out[did] = (int(g.value) if g else 0, int(peak))
        return out

    def check_donation(self, state_in, state_out):
        """Count the tensors of a donating dispatch's input that the chunk
        did not take over (the output holds another buffer for them: the
        runner copied the input in rather than advancing it in place).
        Gated on ``devprof_donation_check``; reads data pointers only."""
        from .. import settings
        if not bool(getattr(settings, "devprof_donation_check", False)):
            return 0
        from ..core.graph import leaves
        out = {t.data_ptr() for _, t in leaves(state_out) if t.numel()}
        missed = sum(1 for _, t in leaves(state_in)
                     if t.numel() and t.data_ptr() not in out)
        if missed:
            self.obs.counter(
                "devprof_donation_missed",
                help="donated input tensors the chunk copied instead of "
                     "advancing in place").inc(missed)
            self.recorder.instant("devprof_donation_missed",
                                  cat="devprof", buffers=missed)
        return missed

    # ------------------------------------------------- profile windows
    @property
    def window_active(self):
        return self._window is not None

    def request_window(self, n_chunks=1, logdir=None):
        """Arm a device-trace window over the next ``n_chunks`` chunk
        dispatches (PROFILE DEVICE).  Returns the trace directory."""
        from .. import settings
        if not logdir:
            base = str(getattr(settings, "trace_dir", "") or "") \
                or str(getattr(settings, "log_path", "output"))
            logdir = os.path.join(base, "devprof")
        self._window_req = (max(int(n_chunks), 1), logdir)
        return logdir

    def begin_chunk(self, seq):
        """The dispatch-side hook: open the armed window (if any) and say
        whether this chunk is inside one.  Admission stops at ``n``: the
        pipeline dispatches chunk k + 1 before chunk k's edge retires."""
        if self._window_req is not None and self._window is None:
            n, logdir = self._window_req
            self._window_req = None
            try:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                os.makedirs(logdir, exist_ok=True)
                prof = profile(activities=acts)
                prof.__enter__()
            except Exception as e:
                self.recorder.instant("device_profile_failed",
                                      cat="devprof", error=str(e)[:200])
                return False
            self._window = {"n": n, "left": n, "admitted": 0,
                            "dir": logdir, "seq0": seq, "prof": prof,
                            "t0": time.perf_counter(), "chunks": {}}
        w = self._window
        if w is None or w["admitted"] >= w["n"]:
            return False
        w["admitted"] += 1
        return True

    @staticmethod
    def fence(device):
        """Wait for ``device`` (a windowed chunk's compute time needs the
        fence); nothing on the CPU."""
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def note_chunk(self, seq, chunk, compute_ms, halo_ms):
        """Record the dispatch side of a windowed chunk (its edge time
        comes with ``note_edge``)."""
        w = self._window
        if w is None:
            return
        w["chunks"][seq] = {"chunk": chunk,
                            "compute_ms": round(float(compute_ms), 3),
                            "halo_ms": round(float(halo_ms), 3),
                            "t0": time.perf_counter()}
        self.obs.histogram(
            "devprof_compute_ms",
            help="windowed chunk device compute wall ms").observe(compute_ms)
        self.obs.histogram(
            "devprof_halo_ms",
            help="windowed chunk pre-dispatch sort/halo wall ms"
        ).observe(halo_ms)

    def note_edge(self, seq, edge_ms):
        """The edge-retirement hook: completes one windowed chunk and
        closes the window after the ``n``-th edge."""
        w = self._window
        if w is None:
            return
        c = w["chunks"].get(seq)
        if c is None:
            return
        c["edge_ms"] = round(float(edge_ms), 3)
        self.obs.histogram(
            "devprof_edge_ms",
            help="windowed chunk host edge-retire wall ms").observe(edge_ms)
        rec = self.recorder
        if rec.enabled:
            rec.complete("devprof_chunk", rec.wall_us(c["t0"]),
                         max(edge_ms, 0.001) * 1e3, cat="devprof",
                         seq=seq, chunk=c["chunk"],
                         compute_ms=c["compute_ms"],
                         halo_ms=c["halo_ms"], edge_ms=c["edge_ms"])
        w["left"] -= 1
        if w["left"] <= 0:
            self._end_window()

    def _end_window(self):
        w, self._window = self._window, None
        if w is None:
            return None
        trace = os.path.join(w["dir"], f"devprof-{w['seq0']}.json")
        try:
            w["prof"].__exit__(None, None, None)
            w["prof"].export_chrome_trace(trace)
        except Exception as e:
            trace = None
            self.recorder.instant("device_profile_failed",
                                  cat="devprof", error=str(e)[:200])
        t1 = time.perf_counter()
        rec = self.recorder
        rec.complete("device_profile", rec.wall_us(w["t0"]),
                     (t1 - w["t0"]) * 1e6, cat="devprof",
                     dir=w["dir"], n_chunks=w["n"], seq0=w["seq0"])
        record = {"dir": w["dir"], "trace": trace, "n_chunks": w["n"],
                  "seq0": w["seq0"], "wall_s": round(t1 - w["t0"], 4),
                  "chunks": w["chunks"]}
        self.windows.append(record)
        self.obs.counter("devprof_windows",
                         help="completed PROFILE DEVICE windows").inc()
        return record

    def abort_window(self):
        """Close a half-open window (the drain and shutdown paths)."""
        if self._window is not None:
            self._window["left"] = 0
            self._end_window()
        self._window_req = None
