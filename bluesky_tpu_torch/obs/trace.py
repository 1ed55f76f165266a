"""Flight recorder: a bounded ring of typed span events, dumped as
Chrome/Perfetto trace-event JSON.

Design points (docs/OBSERVABILITY.md has the user guide,
docs/TORCH_TRACING.md the port's spans and counters):

* **Per-process singleton.**  One ``Recorder`` per process covers the
  sim thread, the node event loop and (in a broker process) the server
  thread — ``pid`` separates processes on the merged timeline, ``tid``
  separates threads inside one.

* **Off = free.**  ``span()`` with the recorder off and no
  ``torch.profiler`` collecting returns a shared no-op context manager
  after two flag checks, and no instrumentation site adds device ops —
  the stepped state is bit-identical with the recorder off (pinned by
  tests/test_torch_trace.py).

* **One span API, three outputs.**  While a ``torch.profiler`` collects
  (``simbench``'s profile window, PROFILE DEVICE), a span also enters
  ``torch.profiler.record_function(name)``, so it lands in the Kineto
  trace as a ``user_annotation`` on CUPTI's clock.  While the recorder
  is on, a span is a ring event with an ``id``, its ``parent`` (the
  innermost span open on the thread) and the chunk's ``seq`` (inherited
  from the parent).  With ``device=True`` and device timing on
  (``enable(device=True)``, TRACE ON DEVICE) it also records a pair of
  CUDA timing events on the current stream; ``resolve`` turns the pairs
  whose end has fired into ``ph: "X"`` events on the ``cuda stream``
  track, placed on the host clock through one anchor (an event and a
  ``perf_counter`` stamp taken together after one ``synchronize`` when
  device timing is switched on).  The Simulation resolves at each chunk
  edge's retirement, after that edge's completion event, so nothing
  waits.  ``count`` attaches device counters to the innermost open span;
  they are copied to pinned host memory on the stream before its end
  event and read by the same ``resolve``.  ``sync(site)`` spans a
  blocking device-to-host wait and counts it in this thread's
  ``syncs()``.

* **Wall-anchored timestamps.**  Events are stamped with
  ``perf_counter`` (monotonic, ns-resolution) shifted by a per-process
  wall anchor captured at import, so dumps from different processes
  land on ONE timeline when ``scripts/trace_report.py`` merges them
  (cross-process skew = NTP-level, fine for ms-scale spans).

* **Typed spans + correlation tags.**  ``SPAN_TYPES`` names the
  vocabulary; tags carry the same correlation ids the BATCH journal
  uses — ``piece`` (scenario name), ``world`` (index in a pack),
  ``seq`` (host-side chunk sequence number), ``epoch`` (mesh epoch) —
  so one piece's sim, worker and server spans line up.

* **Auto-dump.**  Guard/mesh trips dump the ring (throttled) so the
  events *leading up to* an incident survive it.
"""
import itertools
import json
import os
import threading
import time
from collections import deque

import torch

# The span vocabulary.  Unknown names are not rejected (plugins may
# add their own), but everything the core emits is listed here and in
# docs/TORCH_TRACING.md.
SPAN_TYPES = ("chunk_dispatch", "sort_refresh",
              "snapshot_capture", "mesh_check", "hedge", "demux",
              "journal_append", "opt_step", "pack_fill",
              "device_profile", "devprof_chunk",
              # the chunk path (simulation/sim, pipeline, core/graph,
              # core/step) and the kernels' builds (ops/_cuda)
              "sim.step", "sim.plan", "sim.edge", "sync", "step.start",
              "step.replay", "step.eager", "step.pre", "step.post",
              "step.fold", "step.pack", "step.capture", "edge.copy",
              "cuda.build",
              # the ASAS interval (core/asas, ops/cd_sched)
              "asas.interval", "cd.prepare", "cd.k1", "cd.k2", "cd.back",
              "cr.resolve", "asas.partners")

#: the ``tid`` of the device-timed events in a dump
DEVICE_TID = "cuda stream"
#: device spans left unresolved at most (the oldest go first)
_PENDING_MAX = 16384

# Wall anchor: perf_counter() + _EPOCH == time.time() at import, so
# every process's event clocks share one (NTP-aligned) origin.
_EPOCH = time.time() - time.perf_counter()

#: whether a torch.profiler (or the autograd profiler) is collecting
_profiling = torch._C._autograd._profiler_enabled
#: this thread's count of ``sync`` spans (``syncs``)
_SYNCS = threading.local()


def _now_us():
    return (time.perf_counter() + _EPOCH) * 1e6


class _NullSpan:
    """Shared no-op context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **tags):
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One span: a ``record_function`` range while a profiler collects,
    a ring event while the recorder is on, and with ``device`` a pair of
    timing events on the current stream while device timing is on."""
    __slots__ = ("rec", "name", "cat", "tags", "device", "t0", "id",
                 "parent", "rf", "ev0", "counts")

    def __init__(self, rec, name, cat, tags, device):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.tags = tags
        self.device = device
        self.id = self.parent = self.rf = self.ev0 = self.counts = None

    def set(self, **tags):
        """Add tags known only at the span's end (before it closes)."""
        self.tags.update(tags)

    def __enter__(self):
        rec = self.rec
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        if rec.enabled:
            stack = rec._stack()
            if stack:
                parent = stack[-1]
                self.parent = parent.id
                if "seq" not in self.tags and "seq" in parent.tags:
                    self.tags["seq"] = parent.tags["seq"]
            self.id = next(rec._ids)
            stack.append(self)
            if self.device and rec.timing \
                    and not torch.cuda.is_current_stream_capturing():
                self.ev0 = rec._record()
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        rec = self.rec
        if self.id is not None:
            stack = rec._stack()
            if self in stack:    # spans left open inside go with it
                while stack.pop() is not self:
                    pass
            args = dict(self.tags, id=self.id, parent=self.parent)
            rec._append({"name": self.name, "cat": self.cat,
                         "ph": "X", "ts": self.t0,
                         "dur": t1 - self.t0,
                         "pid": os.getpid(),
                         "tid": threading.get_ident(),
                         "args": args})
            if self.ev0 is not None or self.counts:
                rec._pend(self, args)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


class Recorder:
    """Bounded ring of trace events + Perfetto JSON dump."""

    def __init__(self, maxlen=None):
        if maxlen is None:
            from .. import settings
            maxlen = int(getattr(settings, "trace_ring_size", 4096))
        self.enabled = False
        self.counting = False        # device counters (``count``) on
        self.timing = False          # device-timed spans on
        self._ring = deque(maxlen=max(int(maxlen), 16))
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._pending = []           # device spans not yet resolved
        self._free = []              # resolved timing events, reused
        self._anchor = None          # (event, wall us) of one instant
        self._dump_n = 0
        self._last_autodump = -1e18
        self.dumps = []              # paths written this process

    # ---------------------------------------------------------- control
    def enable(self, on=True, device=False):
        """Switch the ring on (or off).  ``device`` also switches on the
        device counters (``count``) and, where CUDA is available, the
        device timing of ``device=True`` spans; the first time, one
        ``synchronize`` anchors the device's clock to the host's."""
        self.enabled = bool(on)
        self.counting = self.enabled and bool(device)
        self.timing = self.counting and torch.cuda.is_available()
        if self.timing and self._anchor is None:
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._anchor = (ev, _now_us())
        return self.enabled

    def disable(self):
        self.enable(False)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._pending.clear()

    def __len__(self):
        return len(self._ring)

    @property
    def maxlen(self):
        return self._ring.maxlen

    # ---------------------------------------------------------- record
    def _append(self, ev):
        with self._lock:
            self._ring.append(ev)

    def _stack(self):
        """This thread's open spans, innermost last."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self):
        """A timing event recorded on the current stream."""
        ev = self._free.pop() if self._free \
            else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _pend(self, span, args):
        """Queue a closing span's device interval and counters for
        ``resolve``: the counters are copied to host memory (pinned, on
        the stream) before the end event is recorded behind them."""
        names = host = end = None
        if span.counts:
            names = [n for n, _ in span.counts]
            vals = torch.stack([v.reshape(()).to(torch.int64)
                                for _, v in span.counts])
            host = vals
            if vals.is_cuda:
                host = torch.empty(vals.shape, dtype=torch.int64,
                                   pin_memory=True)
                host.copy_(vals, non_blocking=True)
        if span.ev0 is not None or (host is not None and host.is_pinned()):
            end = self._record()
        with self._lock:
            self._pending.append((span.name, span.cat, args, span.ev0,
                                  end, names, host))
            del self._pending[:-_PENDING_MAX]

    def span(self, name, cat="sim", device=False, **tags):
        """Duration event context manager (class docstring of ``_Span``);
        the shared no-op when the recorder is off and no profiler
        collects.  ``device`` asks for the span's device time."""
        if not self.enabled and not _profiling():
            return _NULL_SPAN
        return _Span(self, name, cat, tags, device)

    def count(self, name, value):
        """Attach the device counter ``value`` (a 0-d integer tensor) to
        the innermost open span: ``resolve`` reads it with that span into
        the event's args and the registry counter ``name``.  The caller
        computes ``value`` only while ``counting``."""
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = []
            top.counts.append((name, value))

    def resolve(self, registry=None):
        """Write each pending device span whose end event has fired to
        the ring, on the ``DEVICE_TID`` track and the host's clock, with
        its counters in its args and added to ``registry``'s counters;
        keep the others.  Never waits (``Event.query``).  Returns the
        number written."""
        if not self._pending:
            return 0
        with self._lock:
            pend, self._pending = self._pending, []
        keep, done = [], 0
        for item in pend:
            name, cat, args, ev0, end, names, host = item
            if end is not None and not end.query():
                keep.append(item)
                continue
            done += 1
            if names:
                args = dict(args)
                for n, v in zip(names, host.tolist()):
                    args[n] = v
                    if registry is not None:
                        registry.counter(n).inc(v)
            if ev0 is not None:
                anchor, anchor_us = self._anchor
                self._append({"name": name, "cat": cat, "ph": "X",
                              "ts": anchor_us
                              + anchor.elapsed_time(ev0) * 1e3,
                              "dur": ev0.elapsed_time(end) * 1e3,
                              "pid": os.getpid(), "tid": DEVICE_TID,
                              "args": args})
                self._free.append(ev0)
            if end is not None:
                self._free.append(end)
        if keep:
            with self._lock:
                self._pending[:0] = keep
        return done

    def instant(self, name, cat="sim", **tags):
        """Instant event (guard trip, mesh_lost, hedge fired...)."""
        if not self.enabled:
            return
        self._append({"name": name, "cat": cat, "ph": "i",
                      "ts": _now_us(), "s": "p",
                      "pid": os.getpid(),
                      "tid": threading.get_ident(), "args": tags})

    def complete(self, name, t0_us, dur_us, cat="sim", **tags):
        """Record an already-timed duration (for call sites that keep
        their own perf_counter stamps, e.g. the chunk-latency path)."""
        if not self.enabled:
            return
        self._append({"name": name, "cat": cat, "ph": "X",
                      "ts": t0_us, "dur": dur_us, "pid": os.getpid(),
                      "tid": threading.get_ident(), "args": tags})

    @staticmethod
    def wall_us(perf_s=None):
        """Wall-anchored µs for a perf_counter() stamp (default: now)."""
        if perf_s is None:
            return _now_us()
        return (perf_s + _EPOCH) * 1e6

    # ------------------------------------------------------------- dump
    def dump(self, path=None, reason="manual", proc="sim"):
        """Write the ring as Chrome trace-event JSON.  Returns the path
        (atomic tmp+replace write), or None when the ring is empty.
        The ring is NOT cleared: a later dump extends the story."""
        with self._lock:
            events = list(self._ring)
        if not events:
            return None
        if path is None:
            from .. import settings
            d = str(getattr(settings, "trace_dir", "") or "") \
                or str(getattr(settings, "log_path", "output"))
            os.makedirs(d, exist_ok=True)
            self._dump_n += 1
            path = os.path.join(
                d, f"trace-{proc}-{os.getpid()}-{self._dump_n:03d}"
                   f"-{reason}.json")
        else:
            pd = os.path.dirname(path)
            if pd:
                os.makedirs(pd, exist_ok=True)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"proc": proc, "pid": os.getpid(),
                             "reason": reason,
                             "ring": [len(events), self.maxlen]}}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        self.dumps.append(path)
        return path

    def auto_dump(self, reason, proc="sim"):
        """Throttled incident dump (guard/mesh trips): at most one per
        second so a trip storm can't fill the disk; honours the
        ``trace_autodump`` knob."""
        if not self.enabled:
            return None
        from .. import settings
        if not bool(getattr(settings, "trace_autodump", True)):
            return None
        now = time.monotonic()
        if now - self._last_autodump < 1.0:
            return None
        self._last_autodump = now
        try:
            return self.dump(reason=reason, proc=proc)
        except OSError:
            return None          # a bad trace dir never kills the run


_RECORDER = None
_RECORDER_LOCK = threading.Lock()


def syncs() -> int:
    """The blocking device-to-host waits this thread has entered through
    ``sync`` (the Simulation's ``sim_host_syncs`` adds a call's
    difference)."""
    return getattr(_SYNCS, "n", 0)


def sync(site: str):
    """The span of one blocking device-to-host wait at ``site``, counted
    in ``syncs()`` whether the recorder is on or off."""
    _SYNCS.n = syncs() + 1
    return get_recorder().span("sync", site=site)


def get_recorder():
    """The per-process recorder singleton."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = Recorder()
    return _RECORDER
