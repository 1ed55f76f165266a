"""CSV data logging with periodic scheduling.

Parity with reference ``bluesky/tools/datalog.py``: named loggers with a
header, an interval, and a selected-variable list; periodic loggers
(SNAPLOG/INSTLOG/SKYLOG, traffic.py:86-89) sample every dt of sim time into
``LOG_<name>_<scenario>_<timestamp>.log`` CSVs; every logger auto-registers a
stack command ``<NAME> ON/OFF [dt] / LISTVARS / SELECTVARS`` (datalog.py:
106-110, 216-242).

The reference intercepts ``__setattr__`` with a class swap to capture
variable groups (datalog.py:112-139).  Here (a copy of the JAX package's
module) variables are plain named getters over the state; sampling pulls
one device->host transfer per logged chunk edge (never inside a chunk).

Registry scoping: loggers live in a ``LogRegistry``.  Historically the
registry was module-global (one set of loggers per process), which is a
singleton in the hot path once multiple Simulations share a process —
the multi-world serving path (simulation/worlds.py) runs W independent
scenario worlds per worker, and their datalog output must demux into
per-world files instead of interleaving in shared ones.  Every
``Simulation`` therefore owns a registry (``sim.datalog``); standalone
sims share the module default so the classic one-sim-per-process
behavior — and the module-level function API — is unchanged.
"""
import os
import time
from typing import Callable, Dict, Optional

import numpy as np

from .. import settings
from . import asnumpy


def log_dir() -> str:
    """Output directory for logs — reads ``settings.log_path`` at call
    time so tests (and SETLOGPATH-style reconfiguration) can redirect
    all file output without touching module globals."""
    return settings.log_path


class LogRegistry:
    """One named-logger namespace: define/get loggers, sample the due
    ones at chunk edges, register their stack commands.

    ``tag`` is spliced into every log filename (``SNAPLOG_w03_...``) so
    W world registries sharing one output directory stay separable —
    the datalog leg of the multi-world demux.
    """

    def __init__(self, tag: str = ""):
        self.tag = str(tag)
        self._loggers: Dict[str, "CSVLogger"] = {}

    # ------------------------------------------------------------ loggers
    def getlogger(self, name: str) -> Optional["CSVLogger"]:
        return self._loggers.get(name.upper())

    def define_periodic(self, name: str, header: str,
                        dt: float) -> "CSVLogger":
        return CSVLogger(name, header, dt, _traf_getters(), registry=self)

    def define_event(self, name: str, header: str) -> "EventLogger":
        """Create-or-get an event logger (reference datalog.defineLogger)."""
        lg = self.getlogger(name)
        if lg is None:
            lg = EventLogger(name, header, registry=self)
        return lg

    def crelog(self, name: str, header: str, getters=None) -> "CSVLogger":
        return CSVLogger(name, header, 0.0, getters, registry=self)

    # ----------------------------------------------------------- sampling
    def postupdate(self, sim):
        """Sample due periodic loggers (called at chunk edges by the sim)."""
        simt = sim.simt
        for lg in self._loggers.values():
            if lg.active and lg.dt > 0 and simt >= lg.tlog:
                lg.tlog += lg.dt
                lg.log(sim)

    def any_due(self, simt: float) -> bool:
        """Any active periodic logger due at (or before) ``simt``?  The
        pipelined chunk loop asks this before dispatching: logger getters
        read live sim state, so a due sample forces a synchronous edge."""
        return any(lg.active and lg.dt > 0 and simt >= lg.tlog
                   for lg in self._loggers.values())

    def reset(self):
        for lg in self._loggers.values():
            lg.stop()

    def register_stack_commands(self, sim):
        """Give every logger its own stack command (datalog.py:106-110)."""
        cmds = {}
        for name, lg in self._loggers.items():
            cmds[name] = [
                f"{name} ON/OFF,[dt] or LISTVARS or SELECTVARS var1,...",
                "[txt,...]",
                (lambda l: lambda *args: l.stackio(sim, *args))(lg),
                lg.header]
        sim.stack.append_commands(cmds)


class CSVLogger:
    def __init__(self, name: str, header: str, dt: float = 0.0,
                 getters: Optional[Dict[str, Callable]] = None,
                 registry: Optional[LogRegistry] = None):
        self.name = name.upper()
        self.header = header
        self.dt = dt
        self.tlog = 0.0
        self.active = False
        self.file = None
        self.getters = getters or {}
        self.selvars = list(self.getters.keys())
        self.registry = registry if registry is not None else _default
        self.registry._loggers[self.name] = self

    # ----------------------------------------------------------- control
    def start(self, sim, dt: Optional[float] = None):
        if dt is not None:
            self.dt = dt
        os.makedirs(log_dir(), exist_ok=True)
        scen = sim.stack.scenname or "untitled"
        tag = f"{self.registry.tag}_" if self.registry.tag else ""
        stamp = time.strftime("%Y%m%d_%H-%M-%S")
        fname = os.path.join(log_dir(),
                             f"{self.name}_{tag}{scen}_{stamp}.log")
        # never truncate an existing log (two starts in the same
        # wall-clock second would share the timestamped name)
        k = 1
        while os.path.exists(fname):
            fname = os.path.join(
                log_dir(), f"{self.name}_{tag}{scen}_{stamp}_{k}.log")
            k += 1
        self.file = open(fname, "w")
        self.file.write(f"# {self.header}\n")
        self.file.write("# simt, " + ", ".join(self.selvars) + "\n")
        self.tlog = float(sim.simt)
        self.active = True
        return fname

    def stop(self):
        if self.file:
            self.file.close()
            self.file = None
        self.active = False

    def log(self, sim, *extra):
        """Write one sample row set (one line per aircraft for array vars)."""
        if not self.file:
            return
        simt = sim.simt
        cols = []
        for v in self.selvars:
            val = self.getters[v](sim)
            cols.append(np.atleast_1d(asnumpy(val)))
        if not cols:
            return
        nrows = max(c.shape[0] for c in cols)
        for r in range(nrows):
            vals = [f"{simt:.2f}"]
            for c in cols:
                x = c[min(r, c.shape[0] - 1)]
                vals.append(str(x))
            self.file.write(", ".join(vals) + "\n")

    # -------------------------------------------------------- stack cmd
    def stackio(self, sim, *args):
        """``NAME`` / ``NAME ON [dt]`` / ``NAME OFF`` / ``LISTVARS`` /
        ``SELECTVARS var1,...,varn`` (reference datalog.py:216-242)."""
        if not args:
            return True, (f"{self.name} is "
                          f"{'ON' if self.active else 'OFF'}\nUsage: "
                          f"{self.name} ON/OFF,[dt] or LISTVARS or "
                          f"SELECTVARS var1,...,varn")
        f = str(args[0]).upper()
        if f in ("ON", "TRUE", "1"):
            dt = None
            if len(args) > 1:
                try:
                    dt = float(args[1])
                except (TypeError, ValueError):
                    return False, (f"Turn {self.name} on with an "
                                   "optional numeric dt")
            if self.active:
                self.stop()           # ON while ON: rotate the file
            fname = self.start(sim, dt)
            return True, f"{self.name} logging to {fname}"
        if f in ("OFF", "FALSE", "0"):
            self.stop()
            return True
        if f == "LISTVARS":
            return True, "Variables: " + ", ".join(self.getters.keys())
        if f == "SELECTVARS":
            if not self.getters:
                return False, (f"{self.name}: event logger, columns "
                               "are fixed by its producer")
            if self.active and len(args) > 1:
                # the open file's column header is already written
                return False, (f"{self.name} is logging — OFF first, "
                               "then SELECTVARS (the header is fixed "
                               "per file)")
            if len(args) == 1:
                return True, (f"{self.name} selected: "
                              + ", ".join(self.selvars))
            bykey = {k.upper(): k for k in self.getters}
            want, unknown = [], []
            for a in args[1:]:
                k = bykey.get(str(a).upper())
                (want if k else unknown).append(k or str(a))
            if unknown:
                return False, (f"{self.name}: unknown variable(s) "
                               f"{', '.join(unknown)} (LISTVARS shows "
                               "the choices)")
            self.selvars = want
            return True, (f"{self.name} now logs: "
                          + ", ".join(self.selvars))
        return False, f"{self.name}: unknown argument {args[0]}"


class EventLogger(CSVLogger):
    """Event-driven logger: rows are passed explicitly to ``log`` instead
    of sampled through getters (the reference ``datalog.defineLogger``
    pattern used by the AREA plugin's FLST log, plugins/area.py:99,144)."""

    def __init__(self, name: str, header: str,
                 registry: Optional[LogRegistry] = None):
        super().__init__(name, header, dt=0.0, getters={},
                         registry=registry)

    def log(self, sim, *columns, simt=None):
        """Write one row per element; columns are arrays/lists of equal
        length (scalars broadcast).  ``simt`` overrides the timestamp:
        pipelined chunk edges pass their own edge clock so the row is
        stamped with the sampled state's time (and no device sync is
        forced while the next chunk is in flight)."""
        if not self.file or not columns:
            return
        if simt is None:
            simt = sim.simt
        cols = [np.atleast_1d(asnumpy(c)) for c in columns]
        nrows = max(c.shape[0] for c in cols)
        for c in cols:
            if c.shape[0] not in (1, nrows):
                raise ValueError(
                    f"{self.name}: column length {c.shape[0]} != {nrows} "
                    "(only scalars broadcast)")
        for r in range(nrows):
            vals = [f"{simt:.2f}"]
            for c in cols:
                vals.append(str(c[min(r, c.shape[0] - 1)]))
            self.file.write(", ".join(vals) + "\n")


def _traf_getters():
    """Default per-aircraft variable getters (SNAPLOG group,
    traffic.py:94-125)."""
    def arr(field):
        def get(sim):
            st = sim.traf.state
            live = asnumpy(st.ac.active)
            return asnumpy(getattr(st.ac, field))[live]
        return get

    def ids(sim):
        return np.asarray([i for i in sim.traf.ids if i is not None])

    g = {"id": ids}
    for f in ("lat", "lon", "alt", "hdg", "trk", "tas", "gs", "cas", "vs"):
        g[f] = arr(f)
    return g


# ------------------------------------------------- module-level default
# The process-wide default registry: standalone sims and the module
# function API below share it, preserving the classic behavior.  Multi-
# world sims pass their own LogRegistry to Simulation instead.
_default = LogRegistry()
_loggers = _default._loggers      # legacy alias (tests/introspection)


def default_registry() -> LogRegistry:
    return _default


def defineLogger(name: str, header: str) -> "EventLogger":
    return _default.define_event(name, header)


def definePeriodicLogger(name: str, header: str, dt: float) -> CSVLogger:
    return _default.define_periodic(name, header, dt)


def crelog(name: str, header: str, getters=None) -> CSVLogger:
    return _default.crelog(name, header, getters)


def getlogger(name: str) -> Optional[CSVLogger]:
    return _default.getlogger(name)


def postupdate(sim):
    return _default.postupdate(sim)


def any_due(simt: float) -> bool:
    return _default.any_due(simt)


def reset():
    _default.reset()


def register_stack_commands(sim):
    _default.register_stack_commands(sim)
