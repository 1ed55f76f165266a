"""Sim-side plot registry: PLOT x,y,dt streams (x, y, color) series.

Parity with the reference ``tools/plotter.py:15-132``: dotted-name
variable lookup over registered parents, per-plot sample interval,
figure numbering, and a per-chunk update that collects due samples into
stream payloads (``PLOT*`` over ZMQ in node mode; buffered in headless
mode so scripts/tests can read the series directly).

Divergences: variables resolve against the Simulation object tree (no
global singletons) and device arrays are sampled as host copies at chunk
edges; ``sample buffers`` accumulate here instead of relying on a GUI
keeping history.
"""
import re
from collections import defaultdict
from numbers import Number

import numpy as np

from . import asnumpy


def getvarsfromobj(obj):
    """Numeric attributes of an object (plotter.py:48-55)."""
    def is_num(o):
        return isinstance(o, Number) or \
            (isinstance(o, np.ndarray) and o.dtype.kind not in "OSUV")
    try:
        d = vars(obj)
    except TypeError:
        return (obj, [])
    names = []
    for name, val in d.items():
        if hasattr(val, "dtype") or isinstance(val, Number):
            names.append(name)
    return (obj, names)


class Variable:
    def __init__(self, parent, varname, index):
        self.parent = parent
        self.varname = varname
        try:
            self.index = [int(index)] if index else []
        except (ValueError, TypeError):
            self.index = []

    def get(self):
        val = getattr(self.parent, self.varname)
        val = asnumpy(val) if hasattr(val, "dtype") else val
        if self.index:
            return val[tuple(self.index)]
        return val


class Plot:
    """One registered plot (plotter.py:93-132)."""

    def __init__(self, plotter, varx="", vary="", dt=1.0, color=None,
                 fig=None):
        self.x = plotter.findvar(varx if vary else "simt")
        self.y = plotter.findvar(vary or varx)
        self.dt = float(dt)
        self.tnext = plotter.sim.simt
        self.color = color
        if fig is None:
            fig = plotter.maxfig
            plotter.maxfig += 1
        elif fig > plotter.maxfig:
            plotter.maxfig = fig
        self.fig = fig
        self.series = ([], [])          # headless sample history
        if None in (self.x, self.y):
            raise IndexError("Variable %s not found"
                             % (varx if self.x is None else vary))


class Plotter:
    """Per-Simulation plot registry + chunk-edge updater."""

    def __init__(self, sim):
        self.sim = sim
        self.plots = []
        self.maxfig = 0
        self.varlist = {}
        self._extra_parents = {}        # survive refresh_sources()
        self.stream_hook = None         # node mode: send_stream callable
        self.refresh_sources()

    def refresh_sources(self):
        """Register the default variable parents (plotter.py:15-23):
        the sim itself, the traffic facade, and the state arrays."""
        sim = self.sim
        st = sim.traf.state
        self.varlist = {
            "sim": (sim, ["simt", "simdt"]),
            "traf": getvarsfromobj(st.ac),
            "ac": getvarsfromobj(st.ac),
            "asas": getvarsfromobj(st.asas),
            "perf": getvarsfromobj(st.perf),
        }
        # re-resolve registered extra parents (metrics, plugins) so
        # their attribute lists stay current across state replacements
        for name, obj in self._extra_parents.items():
            self.varlist[name] = getvarsfromobj(obj)

    def register_data_parent(self, obj, name):
        self._extra_parents[name] = obj
        self.varlist[name] = getvarsfromobj(obj)

    def findvar(self, varname):
        """Resolve 'name' or 'parent.name[idx]' (plotter.py:57-88)."""
        try:
            varset = re.findall(r"(\w+)(?:\[(\w+)\])?", varname.lower())
            name, index = varset[-1]
            if len(varset) > 1:
                entry = self.varlist.get(varset[0][0])
                if entry is None:
                    return None
                obj = entry[0]
                for pair in varset[1:-1]:
                    if obj is None:
                        return None
                    obj = getattr(obj, pair[0], None)
                if obj is not None and hasattr(obj, name):
                    return Variable(obj, name, index)
            else:
                for el in self.varlist.values():
                    if name in el[1]:
                        return Variable(el[0], name, index)
                if hasattr(self.sim, name):
                    return Variable(self.sim, name, index)
        except (AttributeError, IndexError):
            pass
        return None

    # ------------------------------------------------------------ stack
    def plot(self, *args):
        """PLOT [x],y,[dt],[color] (plotter.py:26-34)."""
        try:
            # State arrays are replaced dataclasses: re-resolve parents so
            # plots bind to the current arrays
            self.refresh_sources()
            self.plots.append(Plot(self, *args))
            return True
        except IndexError as e:
            return False, e.args[0]

    # ----------------------------------------------------------- update
    def update(self, simt):
        """Collect due samples; buffer and/or stream (plotter.py:36-45)."""
        if not self.plots:
            return
        self.refresh_sources()
        streamdata = defaultdict(dict)
        for p in self.plots:
            if p.tnext <= simt + 1e-9:
                p.tnext += p.dt
                # Re-bind to the live state arrays before sampling
                p.x.parent, p.y.parent = self._rebind(p.x), self._rebind(p.y)
                xval = asnumpy(p.x.get()).tolist()
                yval = asnumpy(p.y.get()).tolist()
                p.series[0].append(xval)
                p.series[1].append(yval)
                streamdata[b"PLOT"][p.fig] = (xval, yval, p.color)
        if self.stream_hook is not None:
            for streamname, data in streamdata.items():
                self.stream_hook(streamname, data)

    def _rebind(self, var):
        """State dataclasses are replaced every chunk: find the same-named
        array on the current state if the old parent was one."""
        st = self.sim.traf.state
        for part in (st.ac, st.asas, st.perf):
            if hasattr(part, var.varname) and type(part) is type(var.parent):
                return part
        return var.parent

    def reset(self):
        self.plots = []
        self.maxfig = 0
