"""Metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``bluesky_tpu/obs/metrics.py``, with one repair: the first
``maybe_export`` always writes (the JAX copy starts its rate limit at
monotonic time 0, so on a host up for less than one interval the first
export is skipped).

Dependency-free (stdlib only) so every layer — core step wrappers,
sim, worker node, broker — can register series without import cycles.
Three rules keep it cheap and mergeable:

* **Fixed buckets.**  Histograms are classic Prometheus-style
  cumulative-bucket-free arrays: per-bucket hit counts against a fixed
  upper-bound ladder, plus running sum/count.  Observing is one
  ``bisect`` + two adds; percentiles are linear interpolation inside
  the owning bucket, which is all a fleet aggregate can honestly
  promise anyway.

* **Delta shipping.**  ``Registry.delta()`` returns the increments
  since the previous ``delta()`` call (counters and histogram arrays
  subtract; gauges ship their level).  Worker heartbeats piggyback
  that dict upstream, and the server's fleet registry ``merge()``s it
  — sums of deltas commute, so out-of-order heartbeats from W workers
  still aggregate exactly.

* **Atomic export.**  ``maybe_export()`` rewrites a Prometheus text
  file via tmp+``os.replace`` at most once per interval, so a scraper
  never reads a torn file.
"""
import bisect
import os
import threading
import time

# Wall-clock-ms ladder shared by the latency histograms: sub-ms device
# polls up through multi-second compile/restore stalls.
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
                      5000.0, 10000.0)
# Seconds ladder for queue-wait style series (admission → dispatch).
DEFAULT_S_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5, 5.0, 10.0, 30.0, 60.0, 300.0)


class Counter:
    """Monotonic float counter (``inc`` only; ``_set`` exists for the
    pipe_stats compatibility view and delta merging)."""
    __slots__ = ("name", "help", "_value")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n=1.0):
        self._value += n

    def _set(self, v):
        self._value = float(v)

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-written level (queue depth, ring occupancy, ...)."""
    __slots__ = ("name", "help", "_value")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v):
        self._value = float(v)

    def inc(self, n=1.0):
        self._value += n

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-upper-bound buckets + overflow, with running sum/count."""
    __slots__ = ("name", "help", "bounds", "counts", "sum", "count")

    def __init__(self, name, buckets=DEFAULT_MS_BUCKETS, help=""):
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in buckets)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"{name}: bucket bounds must be sorted")
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def add_counts(self, counts, sum=0.0):
        """Fold a pre-bucketed count vector (same ladder + overflow
        layout) into this histogram — the scanstats drain path, where
        the device already histogrammed per-step values with
        ``searchsorted(side='left')`` (the exact ``bisect_left`` rule
        ``observe`` uses), so bucket counts merge count-exactly."""
        if len(counts) != len(self.counts):
            raise ValueError(
                f"{self.name}: add_counts got {len(counts)} buckets, "
                f"ladder has {len(self.counts)}")
        n = 0
        for i, c in enumerate(counts):
            c = int(c)
            self.counts[i] += c
            n += c
        self.sum += float(sum)
        self.count += n

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p):
        """Estimate the p-quantile (p in [0,1]) by linear interpolation
        inside the owning bucket; the overflow bucket reports its lower
        bound (the best honest answer for an unbounded tail)."""
        if not self.count:
            return 0.0
        rank = p * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if i >= len(self.bounds):          # overflow bucket
                    return self.bounds[-1]
                hi = self.bounds[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]


class Registry:
    """Named metrics with get-or-create accessors, delta shipping and
    Prometheus/human text export.  One per component (each Simulation,
    the broker, the broker's fleet aggregate) — NOT process-global, so
    co-located components (tests run server+worker in one process, a
    WorldBatch runs W sims) never mix series."""

    def __init__(self):
        self._metrics = {}           # name -> Counter/Gauge/Histogram
        # reentrant: merge()/delta() hold it across get-or-create calls
        self._lock = threading.RLock()
        self._delta_base = {}        # name -> shipped-so-far baseline
        self._last_export = None     # monotonic stamp of the last dump

    # ------------------------------------------------------------ access
    def counter(self, name, help=""):
        return self._get_or_make(name, Counter, help=help)

    def gauge(self, name, help=""):
        return self._get_or_make(name, Gauge, help=help)

    def histogram(self, name, buckets=DEFAULT_MS_BUCKETS, help=""):
        return self._get_or_make(name, Histogram, buckets=buckets,
                                 help=help)

    def get(self, name):
        return self._metrics.get(name)

    def _get_or_make(self, name, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"{name} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def __iter__(self):
        return iter(list(self._metrics.values()))

    def __len__(self):
        return len(self._metrics)

    # ---------------------------------------------------------- snapshot
    def snapshot(self):
        """Plain-dict view of every metric (msgpack/JSON-safe)."""
        out = {}
        for m in self:
            if isinstance(m, Counter):
                out[m.name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[m.name] = {"type": "gauge", "value": m.value}
            else:
                out[m.name] = {"type": "histogram",
                               "bounds": list(m.bounds),
                               "counts": list(m.counts),
                               "sum": m.sum, "count": m.count,
                               "p50": m.percentile(0.5),
                               "p95": m.percentile(0.95)}
        return out

    def delta(self):
        """Increments since the previous ``delta()`` call — the payload
        worker heartbeats ship upstream.  Counters/histograms subtract
        against the shipped baseline; gauges ship their current level.
        Zero-change series are omitted so an idle worker's heartbeat
        stays small."""
        with self._lock:
            out = {}
            for m in self:
                if isinstance(m, Counter):
                    base = self._delta_base.get(m.name, 0.0)
                    d = m.value - base
                    if d:
                        out[m.name] = {"type": "counter", "value": d}
                        self._delta_base[m.name] = m.value
                elif isinstance(m, Gauge):
                    out[m.name] = {"type": "gauge", "value": m.value}
                else:
                    base = self._delta_base.get(m.name)
                    if base is None:
                        base = {"counts": [0] * len(m.counts),
                                "sum": 0.0, "count": 0}
                    dcount = m.count - base["count"]
                    if dcount:
                        out[m.name] = {
                            "type": "histogram",
                            "bounds": list(m.bounds),
                            "counts": [a - b for a, b in
                                       zip(m.counts, base["counts"])],
                            "sum": m.sum - base["sum"],
                            "count": dcount}
                        self._delta_base[m.name] = {
                            "counts": list(m.counts),
                            "sum": m.sum, "count": m.count}
            return out

    def merge(self, delta):
        """Fold a ``delta()``/``snapshot()`` dict into this registry
        (the server's fleet aggregate).  Counter/histogram increments
        add — sums of deltas commute, so interleaved heartbeats from
        many workers aggregate exactly; gauges are last-writer."""
        if not delta:
            return
        with self._lock:
            for name, d in delta.items():
                t = d.get("type")
                if t == "counter":
                    self.counter(name).inc(float(d.get("value", 0.0)))
                elif t == "gauge":
                    self.gauge(name).set(float(d.get("value", 0.0)))
                elif t == "histogram":
                    h = self.histogram(name,
                                       buckets=d.get("bounds",
                                                     DEFAULT_MS_BUCKETS))
                    counts = d.get("counts", [])
                    if len(counts) == len(h.counts):
                        for i, c in enumerate(counts):
                            h.counts[i] += int(c)
                    h.sum += float(d.get("sum", 0.0))
                    h.count += int(d.get("count", 0))

    # ------------------------------------------------------------ export
    def prometheus_text(self):
        """Prometheus exposition-format dump (text/plain version 0.0.4,
        cumulative ``le`` buckets).  Series are emitted in sorted-name
        order — NOT registry insertion order, which varies with the
        code path that first touched each series (lazily-registered
        series like the scanstats drain would otherwise reshuffle the
        file between scrapes) — so consecutive ``export()`` files diff
        cleanly (tests/test_obs.py pins the ordering)."""
        lines = []
        for m in sorted(self, key=lambda m: m.name):
            if isinstance(m, Counter):
                lines.append(f"# TYPE {m.name} counter")
                lines.append(f"{m.name} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {m.name} gauge")
                lines.append(f"{m.name} {m.value:g}")
            else:
                lines.append(f"# TYPE {m.name} histogram")
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{m.name}_bucket{{le="{b:g}"}} {cum}')
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{m.name}_sum {m.sum:g}")
                lines.append(f"{m.name}_count {m.count}")
        return "\n".join(lines) + "\n"

    def text(self):
        """Human console dump (the METRICS DUMP echo)."""
        lines = []
        for m in sorted(self, key=lambda m: m.name):
            if isinstance(m, Counter):
                lines.append(f"{m.name}: {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"{m.name}: {m.value:g} (gauge)")
            elif m.count:
                lines.append(
                    f"{m.name}: n={m.count} mean={m.mean:.3g} "
                    f"p50={m.percentile(0.5):.3g} "
                    f"p95={m.percentile(0.95):.3g}")
            else:
                lines.append(f"{m.name}: n=0")
        return "\n".join(lines) if lines else "(no metrics registered)"

    def export(self, path):
        """Atomic Prometheus-text rewrite: tmp + ``os.replace`` so a
        concurrent scraper never reads a torn file."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.prometheus_text())
        os.replace(tmp, path)
        return path

    def maybe_export(self, path=None, interval=None, now=None):
        """Rate-limited ``export()`` driven by the settings knobs —
        called from the sim's after-chunk hook / the server poll loop,
        so no extra thread is needed."""
        if path is None or interval is None:
            from .. import settings
            path = path if path is not None else getattr(
                settings, "metrics_export_path", "")
            interval = interval if interval is not None else float(
                getattr(settings, "metrics_export_dt", 10.0))
        if not path:
            return None
        now = time.monotonic() if now is None else now
        if self._last_export is not None \
                and now - self._last_export < max(float(interval), 0.0):
            return None
        self._last_export = now
        try:
            return self.export(path)
        except OSError:
            return None            # a bad export path never kills a run


_DEFAULT = Registry()


def get_registry():
    """The process-default registry — for code with no owning component
    (scripts, ad-hoc probes).  Sim/server code uses its own instance."""
    return _DEFAULT
