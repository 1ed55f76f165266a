"""Flight recorder: a bounded ring of typed span events, dumped as
Chrome/Perfetto trace-event JSON.

Design points (docs/OBSERVABILITY.md has the user guide):

* **Per-process singleton.**  One ``Recorder`` per process covers the
  sim thread, the node event loop and (in a broker process) the server
  thread — ``pid`` separates processes on the merged timeline, ``tid``
  separates threads inside one.

* **Off = free.**  ``span()`` on a disabled recorder returns a shared
  no-op context manager before touching any argument-dependent work,
  and no instrumentation site adds device ops — the stepped state is
  bit-identical with the recorder off (pinned by tests/test_obs.py).

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
import json
import os
import threading
import time
from collections import deque

# The span vocabulary.  Unknown names are not rejected (plugins may
# add their own), but everything the core emits is listed here and in
# docs/OBSERVABILITY.md.
SPAN_TYPES = ("chunk_dispatch", "chunk_edge", "sort_refresh",
              "snapshot_capture", "mesh_check", "hedge", "demux",
              "journal_append", "opt_step", "pack_fill",
              "device_profile", "devprof_chunk")

# Wall anchor: perf_counter() + _EPOCH == time.time() at import, so
# every process's event clocks share one (NTP-aligned) origin.
_EPOCH = time.time() - time.perf_counter()


def _now_us():
    return (time.perf_counter() + _EPOCH) * 1e6


class _NullSpan:
    """Shared no-op context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("rec", "name", "cat", "tags", "t0")

    def __init__(self, rec, name, cat, tags):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.tags = tags

    def __enter__(self):
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        self.rec._append({"name": self.name, "cat": self.cat,
                          "ph": "X", "ts": self.t0,
                          "dur": t1 - self.t0,
                          "pid": os.getpid(),
                          "tid": threading.get_ident(),
                          "args": self.tags})
        return False


class Recorder:
    """Bounded ring of trace events + Perfetto JSON dump."""

    def __init__(self, maxlen=None):
        if maxlen is None:
            from .. import settings
            maxlen = int(getattr(settings, "trace_ring_size", 4096))
        self.enabled = False
        self._ring = deque(maxlen=max(int(maxlen), 16))
        self._lock = threading.Lock()
        self._dump_n = 0
        self._last_autodump = -1e18
        self.dumps = []              # paths written this process

    # ---------------------------------------------------------- control
    def enable(self, on=True):
        self.enabled = bool(on)
        return self.enabled

    def disable(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._ring.clear()

    def __len__(self):
        return len(self._ring)

    @property
    def maxlen(self):
        return self._ring.maxlen

    # ---------------------------------------------------------- record
    def _append(self, ev):
        with self._lock:
            self._ring.append(ev)

    def span(self, name, cat="sim", **tags):
        """Duration event context manager; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, tags)

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


def get_recorder():
    """The per-process recorder singleton."""
    global _RECORDER
    if _RECORDER is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = Recorder()
    return _RECORDER
