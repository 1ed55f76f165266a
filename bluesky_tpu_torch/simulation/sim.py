"""The simulation loop: fixed-dt stepping, fast-time control, benchmark.

Port of ``bluesky_tpu/simulation/sim.py`` (the embedded, headless
``Simulation``), with the parity of the reference ``Simulation`` node
(simulation/qtgl/simulation.py:18-287): sim states INIT/HOLD/OP/END,
wall-clock pacing with fast-forward and DTMULT, scenario-command
scheduling, BENCHMARK timing, and the event surface (op/pause/reset/ff)
the stack binds to.

The device advances in *chunks* of k steps through the chunk runners of
``core/step.py`` (``run_steps_edge``; on a CUDA state the steps without
an ASAS interval replay CUDA graphs, ``core/graph.py``) and the host
syncs only at chunk edges: stack commands, scenario triggers, loggers
and conditionals run at chunk boundaries.  The default chunk of 20
steps is 1 s of sim time.

Chunk edges are *pipelined* by default (``settings.chunk_pipeline`` /
CHUNKSTEPS PIPELINE): ``step()`` dispatches the next chunk before
running the previous chunk's edge subsystems, which read that chunk's
telemetry pack (``pipeline.ChunkEdge``, copied to pinned host memory
behind the chunk) instead of the live state; the guard word is polled
one chunk deferred, and any edge that must mutate state falls back to a
synchronous chunk that is bit-identical to the unpipelined loop.

The host clocks of the port's state (``simt``, ``fms_t0``,
``asas_tnext``) are host scalars, so reading ``simt`` never waits for
the device.

A sim may be one world of a packed batch (``simulation/worlds.py``,
``WorldBatch``): its ``world_tag`` goes into its log names (through its
tagged ``LogRegistry``) and onto its trace spans, and the batch steps it
through ``_plan_chunk`` and ``_apply_chunk_result`` around one stacked
dispatch for every compatible world.

Durable runs: ``autosave_dt`` (``settings.snapshot_autosave_dt``, off
by default) persists the newest snapshot at chunk edges with the atomic
checksummed writer, and ``request_preempt`` (a signal handler's call)
makes ``run`` drain the chunk in flight, write a final checkpoint and
pause (``handle_preempt``).

Shard modes (``set_shard``, the SHARD command): the sparse backend's
replicate, spatial and tiles decompositions on a single-process mesh
(``parallel/sharding.py``) whose devices may repeat; the spatial and
tiles refreshes re-bucket the caller slots at each due edge (or in the
chunk) and a broken contract falls back tiles -> spatial -> replicate.

A networked worker (``simulation/simnode.py``) wraps the sim: it sets
``node`` and a streaming ``scr`` (``simulation/screenio.py``), and may
attach a raw-TCP stack bridge as ``telnet``
(``network/tcpserver.StackTelnetServer``), pumped at the start of every
host iteration.

Mesh epochs: a sharded run is a sequence of epochs (a set of shards, a
layout, the snapshot it started from).  ``mesh_guard``
(``parallel/sharding.MeshGuard``, from the ``settings.mesh_*`` keys) is
checked at every chunk dispatch; losing a group of shards (FAULT
MESHKILL) ends the epoch, not the run: ``_handle_mesh_lost`` restores
the newest ring snapshot (else the autosave) onto a smaller mesh of the
survivors, degrading tiles -> spatial -> replicate -> one device, and
queues a MESHLOST notice in ``mesh_events`` for the owning node.  The
recovery runs on single-process meshes (one card, or the CPU); a job of
several processes detects a dead peer through the guard's
``guarded_ready`` (``scripts/torch_multihost.py``), and NCCL across
several cards is not measured.

Plugins (``plugins/``, the PLUGINS command; ``settings.enabled_plugins``
load at construction): their hooks run at chunk edges.  The chunk is
clamped to the smallest plugin interval, a due ``preupdate`` retires
the pipelined edge before it runs, a due ``update`` makes its edge
synchronous (sync reason ``plugin``), and with no hook due the
pipelined chunks run on.

Not ported here, each with its ROADMAP item: the radar and web front
ends and their stack surface (A10.7: ``ui/``, SCREENSHOT), and what
comes after it in ROADMAP A10.
"""
import datetime
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core.route import RouteManager
from ..core.step import SimConfig
from ..core.traffic import Traffic
from ..obs import devprof as obs_devprof
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..utils import asnumpy
from .pipeline import ChunkEdge

# Sim states (reference bluesky/__init__.py:12)
INIT, HOLD, OP, END = range(4)


class _SyncReasonsView:
    """dict-like view over the ``sim_sync_reason_<r>`` registry
    counters — keeps the historical ``pipe_stats["sync_reasons"]``
    read/write surface while the data lives in the metrics registry."""
    _PREFIX = "sim_sync_reason_"

    def __init__(self, reg):
        self._reg = reg

    def __getitem__(self, k):
        m = self._reg.get(self._PREFIX + k)
        if m is None:
            raise KeyError(k)
        return int(m.value)

    def __setitem__(self, k, v):
        self._reg.counter(self._PREFIX + k)._set(v)

    def get(self, k, default=None):
        m = self._reg.get(self._PREFIX + k)
        return default if m is None else int(m.value)

    def __contains__(self, k):
        return self._reg.get(self._PREFIX + k) is not None

    def __iter__(self):
        for m in self._reg:
            if isinstance(m, obs_metrics.Counter) \
                    and m.name.startswith(self._PREFIX):
                yield m.name[len(self._PREFIX):]

    def keys(self):
        return list(self)

    def items(self):
        return [(k, self[k]) for k in self]

    def __len__(self):
        return sum(1 for _ in self)

    def __eq__(self, other):
        return dict(self.items()) == other

    def __repr__(self):
        return repr(dict(self.items()))


class _PipeStatsView:
    """The historical ``sim.pipe_stats`` dict surface, backed by the
    sim's metrics registry: reads/writes go to the
    ``sim_chunks_*`` counters, ``"sync_reasons"`` to the per-reason
    counter family, so HEALTH/CHUNKSTEPS readbacks, tests and the
    multi-world runner keep working unchanged."""
    _COUNTERS = {"pipelined_chunks": "sim_chunks_pipelined",
                 "sync_chunks": "sim_chunks_sync",
                 "deferred_trips": "sim_deferred_trips"}
    #: counters made on their first count only (0 until then), so a sim
    #: that never counts them keeps its registry as it was
    _LAZY = {"render_errors": "ui_render_errors"}    # ui/web.py pump

    def __init__(self, reg):
        self._reg = reg
        self._reasons = _SyncReasonsView(reg)
        for name in self._COUNTERS.values():
            reg.counter(name)

    def __getitem__(self, k):
        if k == "sync_reasons":
            return self._reasons
        if k in self._LAZY:
            m = self._reg.get(self._LAZY[k])
            return 0 if m is None else int(m.value)
        return int(self._reg.counter(self._COUNTERS[k]).value)

    def __setitem__(self, k, v):
        self._reg.counter({**self._COUNTERS, **self._LAZY}[k])._set(v)

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def keys(self):
        return list(self._COUNTERS) + list(self._LAZY) + ["sync_reasons"]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __contains__(self, k):
        return k in self._COUNTERS or k in self._LAZY or k == "sync_reasons"

    def __repr__(self):
        return repr({k: (dict(v.items())
                         if k == "sync_reasons" else v)
                     for k, v in self.items()})


class DisplayState:
    """Display state of the headless Screen (the JAX package's node-mode
    ScreenIO duck-types the same surface): shape registry, pan
    centre, zoom, feature switches, altitude filter, symbol toggle,
    editline inserts, ND selection.  Every display command in the stack
    works against this mixin in both modes."""

    def _init_display(self):
        self.objdata = {}     # named display shapes (screenio objappend)
        self.ctrlat = 0.0
        self.ctrlon = 0.0
        self.scrzoom = 1.0
        self.user_view = False  # True once PAN/ZOOM issued (radar.py)
        self.features = {}
        self.altfilter = None       # (bottom, top) in meters or None
        self.swsymbol = True
        self.editline = ""
        self.nd_acid = None
        self.route_acid = ""        # ROUTEDATA selection (showroute)
        self.ssd_all = False        # SSD disc selection (reference
        self.ssd_conflicts = False  # guiclient.py:283-296 show_ssd)
        self.ssd_ownship = set()

    def showroute(self, acid=""):
        """Select the aircraft whose route streams in ROUTEDATA
        (reference scr.showroute, called from POS)."""
        self.route_acid = acid
        return True

    def reset(self):
        """Clear display state on sim RESET (reference ScreenIO.reset)."""
        self._init_display()

    def getviewbounds(self):
        """Lat/lon box currently in view (screenio pan/zoom state)."""
        half = 1.0 / max(self.scrzoom, 1e-9)
        return (self.ctrlat - half, self.ctrlat + half,
                self.ctrlon - half, self.ctrlon + half)

    def objappend(self, objtype, objname, data):
        """Mirror a named shape to the display (screenio.py objappend);
        empty objtype deletes."""
        if not objtype:
            self.objdata.pop(objname, None)
        else:
            self.objdata[objname] = (objtype, data)
        return True

    def addnavwpt(self, name, lat, lon):
        """Mirror a user-defined waypoint to the display (reference
        navdatabase.py:136 -> scr.addnavwpt; ScreenIO broadcasts it as
        the DEFWPT event the Qt client consumes, guiclient.py:232)."""
        self.custwpts = getattr(self, "custwpts", {})
        self.custwpts[name] = (float(lat), float(lon))
        return True

    def pan(self, lat, lon):
        self.ctrlat = float(lat)
        self.ctrlon = float(lon)
        self.user_view = True       # radar stops auto-fitting
        return True

    def zoom(self, factor, absolute=False):
        self.scrzoom = float(factor) if absolute \
            else self.scrzoom * float(factor)
        self.user_view = True
        return True

    def feature(self, sw, arg=None):
        """SWRAD switches (screenio.feature): toggle/record per name."""
        self.features[sw.upper()] = arg if arg is not None \
            else not self.features.get(sw.upper(), False)
        return True

    def filteralt(self, flag, bottom=None, top=None):
        self.altfilter = (bottom, top) if flag else None
        return True

    def symbol(self):
        self.swsymbol = not self.swsymbol
        return True

    def cmdline(self, text):
        """INSEDIT: text inserted on the console edit line."""
        self.editline = text
        return True

    def shownd(self, acid=None):
        self.nd_acid = acid
        return True

    def show_ssd(self, *args):
        """Select which aircraft draw their solution-space disc on the
        radar (reference guiclient.py:283-296: ALL / CONFLICTS / OFF or
        a toggled set of callsigns)."""
        arg = {str(a).upper() for a in args}
        if "ALL" in arg:
            self.ssd_all, self.ssd_conflicts = True, False
        elif "CONFLICTS" in arg:
            self.ssd_all, self.ssd_conflicts = False, True
        elif "OFF" in arg:
            self.ssd_all, self.ssd_conflicts = False, False
            self.ssd_ownship = set()
        else:
            remove = self.ssd_ownship.intersection(arg)
            self.ssd_ownship = self.ssd_ownship.union(arg) - remove
        return True


class Screen(DisplayState):
    """Echo/plot sink — headless stand-in for ScreenIO (screenio.py:11-263).

    Collects echo lines so stack command output is observable; the network
    node subclass streams instead.
    """

    def __init__(self):
        self.echobuf = []
        self._init_display()

    def echo(self, text="", flags=0):
        self.echobuf.append(text)
        return True


class Simulation:
    """Host simulation driver owning traffic, config and the step loop.

    ``Simulation(nmax, wmax, dtype, ..., device=None)`` builds its
    ``Traffic`` on ``device`` (``bluesky_tpu_torch.resolve_device``:
    CUDA unless the caller asks for another device; without CUDA and
    without ``device`` it raises)."""

    # Allowed chunk sizes, largest first (each size and gate pattern is
    # one set of captured graphs per SimConfig on the card).
    CHUNK_LADDER = (1000, 200, 20, 5, 1)

    def __init__(self, nmax: int = 1024, wmax: int = 32, dtype=None,
                 openap_path: Optional[str] = None, rng_seed: int = 0,
                 chunk_steps: Optional[int] = None,
                 datalog_registry=None, device=None, world_tag: str = "",
                 pair_matrix: bool = True):
        # Multi-world identity (simulation/worlds.py): a non-empty tag
        # marks this sim as one world of a packed batch; it labels the
        # sim's trace spans (its log names carry it through its tagged
        # LogRegistry).  host_tag names the owning worker for on-disk
        # names (set by the batch runner).
        self.world_tag = str(world_tag)
        self.host_tag = ""
        # pair_matrix=False leaves out the dense backend's [N, N]
        # resopairs (a blockwise backend's large fleets)
        self.traf = Traffic(nmax=nmax, wmax=wmax,
                            dtype=dtype or torch.float32,
                            openap_path=openap_path, rng_seed=rng_seed,
                            pair_matrix=pair_matrix, device=device)
        self.routes = RouteManager(self.traf, wmax)
        self.scr = Screen()
        self.cfg = SimConfig()
        self.state_flag = INIT
        # Per-sim datalog registry (utils/datalog.LogRegistry): assigned
        # BEFORE metrics/guard construction — both define event loggers
        # into it.  Standalone sims share the process default registry.
        from ..utils import datalog as _datalog
        self.datalog = datalog_registry if datalog_registry is not None \
            else _datalog.default_registry()
        from .. import settings
        # Interactive chunk length: settings knob + CHUNKSTEPS stack
        # command (ctor arg overrides for embedded use)
        self.chunk_steps = int(chunk_steps if chunk_steps is not None
                               else settings.chunk_steps)
        # Chunk pipeline: when on, step() dispatches chunk k+1 before
        # running chunk k's edge subsystems off its telemetry pack, with
        # a synchronous fallback whenever edge work must mutate state.
        self.pipeline_enabled = bool(settings.chunk_pipeline)
        self._pending_edge = None    # ChunkEdge of the in-flight chunk
        self._simt_next = 0.0        # predicted clock after that chunk
        self._last_edge = None       # newest retired edge (ACDATA cache)
        self._retiring = False       # reentrancy guard for drains
        # In-chunk telemetry (obs/scanstats.py), drained at each edge;
        # the SCANSTATS stack command toggles it at runtime.
        if settings.scanstats:
            self.cfg = self.cfg._replace(scanstats=True)
        self._scan_last = None       # newest drained chunk summary dict
        # In-chunk sort refresh of the sparse backend (SORTREFRESH).
        if settings.inscan_refresh:
            self.cfg = self.cfg._replace(inscan_refresh=True)
        self._sort_t_chain = None    # previous chunk's RefreshPack
        #                              sort_t, chained into the next
        #                              dispatch (pipelined chunks)
        self._refresh_fired = 0      # in-chunk refreshes retired so far
        # State fingerprint (obs/fingerprint.py), chained host-side;
        # the FINGERPRINT stack command toggles it at runtime.
        if settings.fingerprint:
            self.cfg = self.cfg._replace(fingerprint=True)
        self._fp_chain = 0           # running piece-chain fold (32-bit)
        self._fp_chunks = 0          # chunks folded into the chain
        self._fp_steps = 0           # steps folded into the chain
        self._fp_corrupt_mask = 0    # FAULT BITFLIP PAYLOAD: XORed into
        #                              every shipped fingerprint word
        # Observability: a per-sim metrics registry + the per-process
        # flight recorder.  pipe_stats is a view over the registry.
        self.obs = obs_metrics.Registry()
        self.recorder = obs_trace.get_recorder()
        if settings.trace_enabled:
            self.recorder.enable()
        self.pipe_stats = _PipeStatsView(self.obs)
        self.obs.counter("sim_guard_trips",
                         help="integrity-guard trips (all policies)")
        self.obs.counter("sim_inscan_refreshes",
                         help="sort refreshes fired inside chunks")
        self.obs.counter("sim_mesh_trips",
                         help="mesh-epoch events (mesh_lost+resharded)")
        _h = self.obs.histogram
        _h("sim_chunk_latency_ms",
           help="chunk dispatch -> edge retirement wall ms")
        _h("sim_dispatch_gap_ms",
           help="host gap between consecutive chunk dispatches")
        _h("sim_edge_pull_ms",
           help="wait for an edge's telemetry on the host, wall ms")
        _h("sim_sort_refresh_ms",
           help="spatial-sort refresh wall ms")
        _h("sim_snapshot_capture_ms",
           help="snapshot-ring capture wall ms")
        self._edge_pull_sink = \
            self.obs.get("sim_edge_pull_ms").observe
        self._chunk_seq = 0          # host-side dispatch sequence tag
        self._seq_dispatched = 0     # tag of the newest dispatch
        self._last_dispatch_end = None   # wall stamp: dispatch-gap series
        # Device observability (obs/devprof.py): compile telemetry,
        # memory watermarks and PROFILE DEVICE windows; every hook returns
        # on attribute checks when its feature is off.
        self.devprof = obs_devprof.DevProf(
            self.obs, self.recorder, ladder=self.CHUNK_LADDER,
            state_fn=lambda: self.traf.state)
        self.dtmult = 1.0
        self.ffmode = False
        self.ffstop: Optional[float] = None
        self.syst = -1.0          # wall-clock anchor
        self.bencht = 0.0
        self.benchdt = -1.0
        self._step_count = 0
        self._sort_simt = -1.0    # simt of last spatial-sort refresh
        self._sort_backend = None  # cd_backend the cached sort belongs to
        self._utc0 = datetime.datetime.combine(datetime.date.today(),
                                               datetime.time())
        # Named areas + deferred conditional commands (chunk-edge subsystems)
        from ..utils.areafilter import AreaRegistry
        from ..core.conditional import ConditionList
        from ..utils.plotter import Plotter
        self.areas = AreaRegistry(self.scr)
        self.cond = ConditionList(self)
        self.plotter = Plotter(self)
        from ..core.metrics import Metrics
        self.metrics = Metrics(self)
        self.telnet = None            # StackTelnetServer when enabled
        # Fault tolerance: periodic in-memory snapshot ring + the
        # state-integrity guard responding to in-chunk finite trips.
        from .snapshot import SnapshotRing
        from ..fault.guard import IntegrityGuard
        self.snap_ring = SnapshotRing(depth=settings.snap_ring_depth,
                                      dt=settings.snap_ring_dt)
        self.guard = IntegrityGuard(self)
        # Durable runs: the periodic on-disk autosnapshot (off by
        # default: one atomic write per interval) and the preemption flag
        # a signal handler raises; an embedded run checkpoints and pauses.
        self.autosave_dt = float(settings.snapshot_autosave_dt)
        self._autosave_t = -float("inf")
        self.preempt_requested = False
        # FAULT STRAGGLE (fault/injectors.straggle): the merely-slow /
        # stuck-but-alive worker.  Both survive RESET on purpose: they
        # model the host, not the scenario.
        self.straggle_factor = 0.0    # extra wall-s owed per sim-s
        self.straggle_stall = False   # freeze progress, keep loop alive
        self._straggle_debt = 0.0     # owed throttle sleep, paid in
        #                               small slices so the node loop
        #                               keeps pumping heartbeats
        self.traf.delete_hooks.append(self.cond.delac)
        self.traf.permute_hooks.append(self.cond.permute)
        # Spatial and tiles modes: a freshly created aircraft has no
        # sorted slot until the next refresh, so a creation forces the
        # refresh at the next dispatch (in the same host edge as the
        # flush: no chunk steps an aircraft CD cannot see).
        self.traf.create_hooks.append(
            lambda slots: self._invalidate_sort()
            if self.shard_mode in ("spatial", "tiles") else None)
        self._shard_fallback = False
        # Shard modes (SHARD): 'off' | 'replicate' | 'spatial' | 'tiles'
        self.shard_mode = "off"
        self.shard_mesh = None
        self.shard_stats = {}
        self._mesh_refresh_ms = 0.0  # wall ms of the last shard refresh
        # Mesh epochs: the MeshGuard is consulted at every chunk
        # dispatch; losing a group of shards ends the epoch (a mesh_lost
        # trip, the snapshot re-sharded onto the survivors in
        # _handle_mesh_lost), not the run.
        from ..parallel.sharding import MeshGuard
        self.mesh_epoch = 0
        self.mesh_degraded = False
        self.mesh_events = []        # pending MESHLOST notices (simnode)
        self.mesh_guard_enabled = bool(settings.mesh_guard_enabled)
        self.mesh_guard = MeshGuard(
            heartbeat_dir=settings.mesh_heartbeat_dir or None,
            timeout=float(settings.mesh_dispatch_timeout),
            hb_timeout=float(settings.mesh_heartbeat_timeout))
        self._refresh_guard = 0      # in-chunk refresh guard trips
        # Late import to avoid cycles; stack binds commands to this sim.
        from ..stack.stack import Stack
        self.stack = Stack(self)
        # Plugin system (discovery + hook scheduling at chunk edges);
        # enabled_plugins from settings are best-effort (plugin.py:103-105).
        from ..plugins import PluginManager
        self.plugins = PluginManager(self)
        for pname in settings.enabled_plugins:
            self.plugins.load(pname.upper())
        # Periodic loggers (reference traffic.py:86-89 defaults: SNAPLOG/
        # INSTLOG/SKYLOG) + their auto-registered stack commands, in
        # this sim's own registry.
        for name, dt in (("SNAPLOG", 30.0), ("INSTLOG", 30.0),
                         ("SKYLOG", 60.0)):
            if self.datalog.getlogger(name) is None:
                self.datalog.define_periodic(name, f"{name} logfile.", dt)
        self.datalog.register_stack_commands(self)

    @property
    def navdb(self):
        """Lazy shared navigation database (loads on first named-position
        lookup)."""
        from ..navdb import get_navdb
        return get_navdb()

    # ----------------------------------------------------------- time/state
    @property
    def simt(self) -> float:
        """The sim clock: a host scalar of the state, no device read."""
        return float(self.traf.state.simt)

    @property
    def simt_planned(self) -> float:
        """The sim clock of the edge of the chunk in flight (pipelined
        stepping): the host's prediction, exact, because it folds the
        per-step additions in the state's own float dtype as the chunk
        runner does.  With no chunk in flight it is ``simt``."""
        if self._pending_edge is not None:
            return self._simt_next
        return self.simt

    @property
    def simdt(self) -> float:
        return self.cfg.simdt

    def setdt(self, dt: float):
        self.cfg = self.cfg._replace(simdt=float(dt))
        return True

    @property
    def utc(self):
        """Simulated UTC clock = epoch + simt (simulation.py setutc)."""
        return self._utc0 + datetime.timedelta(seconds=self.simt)

    def setutc(self, *args):
        """TIME/DATE: RUN / REAL/UTC / HH:MM:SS.hh / day,month,year,time
        (reference simulation.py setutc)."""
        if not args or args[0] is None or str(args[0]).upper() == "RUN":
            self._utc0 = datetime.datetime.combine(
                datetime.date.today(), datetime.time()) \
                - datetime.timedelta(seconds=self.simt)
            return True
        a0 = str(args[0]).upper()
        if a0 in ("REAL", "UTC"):
            now = datetime.datetime.now(datetime.timezone.utc) \
                .replace(tzinfo=None) if a0 == "UTC" \
                else datetime.datetime.now()
            self._utc0 = now - datetime.timedelta(seconds=self.simt)
            return True
        try:
            if len(args) >= 4:   # DATE day, month, year, HH:MM:SS
                day, month, year = int(args[0]), int(args[1]), int(args[2])
                t = datetime.datetime.strptime(
                    str(args[3]).split(".")[0], "%H:%M:%S").time()
                base = datetime.datetime.combine(
                    datetime.date(year, month, day), t)
            else:                # TIME HH:MM:SS[.hh]
                t = datetime.datetime.strptime(
                    a0.split(".")[0], "%H:%M:%S").time()
                base = datetime.datetime.combine(self.utc.date(), t)
        except ValueError as e:
            return False, f"TIME/DATE: {e}"
        self._utc0 = base - datetime.timedelta(seconds=self.simt)
        return True

    def setFixdt(self, flag, tend=None):
        """FIXDT ON/OFF [tend]: fixed-dt stepping — equivalent to
        fast-forward pacing in this architecture (simulation.py
        setFixdt)."""
        if flag:
            self.fastforward(tend)
        else:
            self.ffmode = False
        return True

    def setdtmult(self, mult: float):
        self.dtmult = float(mult)
        return True

    def op(self):
        """Start/resume (reference simulation.py OP)."""
        self.state_flag = OP
        self.syst = -1.0
        self.ffmode = False
        return True

    def pause(self):
        self._retire_edge("pause")
        self.state_flag = HOLD
        return True

    def stop(self):
        self._retire_edge("stop")
        self.state_flag = END
        self.datalog.reset()
        return True

    def reset_traffic(self):
        """Traffic-scoped reset: clear aircraft + routes + deferred
        conditions, keep sim settings/stack/logs.

        Mirrors the reference's ``bs.traf.reset()`` (trafficarrays cascade:
        routes and conditional commands are traf children there), which is
        what the SYN generators call (reference synthetic.py:48,58,...) —
        unlike the full ``reset`` they must NOT wipe SimConfig (CDMETHOD,
        DT) or datalog state."""
        self._retire_edge("reset")
        self._last_edge = None
        self.traf.reset()
        self.cond.reset()
        self.routes = RouteManager(self.traf, self.routes.wmax)
        self._invalidate_sort()
        return True

    def reset(self):
        self._retire_edge("reset")
        self._last_edge = None
        self.state_flag = INIT
        self._invalidate_sort()
        self.traf.reset()
        self.areas.reset()
        self.cond.reset()
        self.routes = RouteManager(self.traf, self.routes.wmax)
        # scanstats/inscan_refresh/fingerprint are runtime knobs, not
        # scenario state (like the TRACE recorder): the toggles survive
        # RESET while the rest of the config rebuilds to defaults
        self.cfg = SimConfig(scanstats=self.cfg.scanstats,
                             inscan_refresh=self.cfg.inscan_refresh,
                             fingerprint=self.cfg.fingerprint)
        self._scan_last = None
        # a new scenario starts a fresh fingerprint chain
        self._fp_chain = 0
        self._fp_chunks = 0
        self._fp_steps = 0
        self._fp_corrupt_mask = 0
        # traf.reset rebuilt default-shape tables on the default device
        self.shard_mode, self.shard_mesh = "off", None
        self.shard_stats = {}
        self._shard_fallback = False
        # a new scenario starts a fresh mesh-epoch history
        self.mesh_guard.set_mesh(None)
        self.mesh_guard.epoch = 0
        self.mesh_epoch = 0
        self.mesh_degraded = False
        self.mesh_events = []
        self._mesh_refresh_ms = 0.0
        self.dtmult = 1.0
        self.ffmode = False
        self.stack.reset()
        self.datalog.reset()
        self.scr.reset()
        self.metrics.reset()
        self.snap_ring.clear()
        self.guard.reset()
        self._autosave_t = -float("inf")
        # a preemption notice raised before the RESET must not fire into
        # the fresh sim
        self.preempt_requested = False
        # After stack.reset: plugin reset hooks may stack commands (e.g.
        # TRAFGEN redraws its spawn circle) that must survive the reset.
        self.plugins.reset()
        self.plotter.reset()
        return True

    def scan_health(self):
        """The HEALTH ``sim`` section: in-chunk telemetry enablement plus
        the newest drained chunk's summary (obs/scanstats.summarize) and
        the sort-refresh readback.  Pure host state: no device reads."""
        d = dict(scanstats=bool(self.cfg.scanstats),
                 fingerprint=bool(self.cfg.fingerprint),
                 sort_refresh=self.refresh_health())
        if self._scan_last is not None:
            d.update(self._scan_last)
        return d

    def set_scanstats(self, on: bool) -> bool:
        """Toggle in-chunk telemetry.  Drains the pipeline first (the
        in-flight chunk ran with the OLD flag and its edge must retire
        under it).  Returns True if the flag changed."""
        on = bool(on)
        if on == bool(self.cfg.scanstats):
            return False
        self.drain_pipeline()
        self.cfg = self.cfg._replace(scanstats=on)
        if not on:
            self._scan_last = None
        return True

    # ------------------------------------------------------ fingerprint
    def set_fingerprint(self, on: bool) -> bool:
        """Toggle the state-fingerprint fold (``set_scanstats``
        contract).  Turning it ON mid-piece starts the chain at the
        current state."""
        on = bool(on)
        if on == bool(self.cfg.fingerprint):
            return False
        self.drain_pipeline()
        self.cfg = self.cfg._replace(fingerprint=on)
        self._fp_chain = 0
        self._fp_chunks = 0
        self._fp_steps = 0
        return True

    def fp_summary(self):
        """The fingerprint summary of the running chain, or None before
        any chunk folded.  A FAULT BITFLIP PAYLOAD mask corrupts every
        shipped word until the next RESET (the wire-corruption model: the
        stepped state and the device fold stay untouched)."""
        if not self.cfg.fingerprint or self._fp_chunks == 0:
            return None
        from ..obs import fingerprint as fpmod
        word = (self._fp_chain ^ self._fp_corrupt_mask) & 0xFFFFFFFF
        return fpmod.summarize(word, self._fp_chunks, self._fp_steps)

    def _drain_fingerprint(self, edge) -> None:
        """Retire one edge's FingerprintPack (host arrays) into the
        running piece chain."""
        if edge.fingerprint is None:
            return
        from ..obs import fingerprint as fpmod
        pack = edge.fingerprint
        edge.fingerprint = None
        chunk_fp = fpmod.drain(self.obs, pack)
        self._fp_chain = fpmod.chain(self._fp_chain, chunk_fp)
        self._fp_chunks += 1
        self._fp_steps += int(pack.steps)
        self.recorder.instant("fingerprint_chunk", cat="sdc",
                              fp=format(chunk_fp, "08x"),
                              chain=format(self._fp_chain, "08x"))

    # ------------------------------------------------- in-chunk sort refresh
    def _invalidate_sort(self):
        """THE spatial-sort invalidation point: every event that voids
        the cached sort — RESET, snapshot restore, backend switch —
        routes through here, so the refresh due-gate (host edge or the
        in-chunk RefreshPack seed) has a single source of truth."""
        self._sort_simt = -1.0
        self._sort_backend = None
        self._sort_t_chain = None

    def _inscan_refresh_active(self) -> bool:
        """Does the CURRENT config fold the sort refresh into the chunk?
        (core/step.inscan_refresh_active: flag on + sparse backend.)"""
        from ..core.step import inscan_refresh_active
        return inscan_refresh_active(self.cfg)

    def set_inscan_refresh(self, on: bool) -> bool:
        """Toggle the in-chunk sort refresh (SORTREFRESH command).
        Drains the pipeline first.  Returns True if the flag changed."""
        on = bool(on)
        if on == bool(self.cfg.inscan_refresh):
            return False
        self.drain_pipeline()
        self.cfg = self.cfg._replace(inscan_refresh=on)
        if not on:
            # host refresh resumes from the last retired edge's sort_t
            self._sort_t_chain = None
        return True

    def _sort_t0_for_dispatch(self, state):
        """The in-chunk due-gate seed for the next dispatch (a host
        scalar in the state's dtype): the previous chunk's RefreshPack
        ``sort_t`` when one is chained, else the host's last-refresh
        time (-1 after any invalidation, and after a backend switch:
        'sparse' stores stripe destinations in sort_perm, the others a
        Morton permutation, so a stale cross-backend sort must refresh
        at the first step)."""
        if self._sort_t_chain is not None:
            return self._sort_t_chain
        t = self._sort_simt
        if self._sort_backend != self.cfg.cd_backend:
            t = -1.0
        return state.simt.dtype.type(t)

    def _retire_refresh(self, edge):
        """Retire one edge's in-chunk RefreshPack: fold the refresh
        bookkeeping back into host state (last-refresh time, counters),
        apply the composed caller-slot bijection of the spatial and
        tiles refreshes to the host tables exactly once, and trip the
        fallback on a guard word.  Runs BEFORE the edge's other
        consumers, so the host tables align with the pack's slot order.
        No-op when the edge carries no pack."""
        pack = edge.refresh
        if pack is None:
            return
        edge.refresh = None          # idempotent: permute exactly once
        self._sort_simt = float(pack.sort_t)
        self._sort_backend = self.cfg.cd_backend
        count, guard = int(pack.count), int(pack.guard)
        if count > 0:
            self._refresh_fired += count
            self.obs.counter("sim_inscan_refreshes").inc(count)
            if pack.newslot.numel():
                newslot = asnumpy(pack.newslot)
                if not np.array_equal(newslot, np.arange(newslot.size)):
                    self.traf.apply_slot_permutation(newslot)
                    # an older published edge is in the old slot order
                    self._last_edge = None
        if guard != 0:
            self._refresh_guard += 1
            why = []
            if guard & 1:
                why.append("stripe occupancy overflow")
            if guard & 2:
                why.append("halo coverage/slab budget violated")
            if guard & 4:
                why.append("tile occupancy overflow")
            self.scr.echo(f"SHARD {self.shard_mode.upper()} contract "
                          "violated in-scan: " + ", ".join(why)
                          + " (refresh skipped; falling back)")
            self._shard_fallback = True

    def refresh_health(self):
        """The HEALTH ``sim`` sort-refresh readback: mode, due-gate
        state and retired in-chunk counters (SORTREFRESH shows the same
        numbers).  Pure host state: no device reads."""
        return dict(inscan=bool(self.cfg.inscan_refresh),
                    active=self._inscan_refresh_active(),
                    last_refresh_simt=float(self._sort_simt),
                    inscan_refreshes=int(self._refresh_fired),
                    guard_trips=int(self._refresh_guard))

    # -------------------------------------------------------------- sharding
    @staticmethod
    def _default_tile_shape(ndev: int):
        """Near-square R x C factorization of ``ndev`` with R >= C (more
        latitude bands than longitude buckets): 8 -> 4x2, 4 -> 2x2,
        6 -> 3x2; a prime gives ndev x 1."""
        ndev = int(ndev)
        c = int(np.sqrt(ndev))
        while c > 1 and ndev % c:
            c -= 1
        return (ndev // max(c, 1), max(c, 1))

    def _shard_ndev(self, default=0):
        """Shards of the bound mesh (the 'ac' mesh or the tile mesh)."""
        return int(self.shard_mesh.devices.size) if self.shard_mesh \
            else int(default)

    def _mesh_devs(self):
        """The bound mesh's devices in shard order (a fallback re-forms
        the mesh over them), or None without a mesh."""
        if self.shard_mesh is None:
            return None
        return list(self.shard_mesh.devices.ravel())

    def set_shard(self, mode: str, ndev: int = 0, halo_blocks: int = 0,
                  devices=None, tiles=None):
        """Select the shard mode: ``off`` | ``replicate`` | ``spatial`` |
        ``tiles`` over the first ``ndev`` devices (0 = all) of
        ``devices`` (default the visible GPUs, or one CPU for a sim on the
        CPU; ``sharding.default_devices``).  The list may repeat a device:
        ``devices=[torch.device("cuda:0")] * 4`` runs four shards on one
        card.

        ``replicate``: the state whole on the mesh's first device, the
        sparse and pallas kernels' rows split over the shards against
        replicated columns.  ``spatial`` (sparse backend): shard-owned
        latitude stripes with a halo exchange; the aircraft are
        re-bucketed into the owning shard's caller rows at every sort
        refresh.  ``tiles`` (sparse backend): 2-D lat x lon tiles
        (``tiles=(R, C)``, default a near-square factorization of
        ndev) with the edge and corner exchange.  Switching modes
        resets the engagement hysteresis (pairs re-detect at the next
        interval).  Raises ``ValueError`` or ``RuntimeError`` for a mode
        that cannot run, as JAX's."""
        from ..parallel import sharding as shd
        mode = str(mode).lower()
        if mode not in ("off", "replicate", "spatial", "tiles"):
            raise ValueError(f"SHARD {mode}: off/replicate/spatial/tiles")
        self.drain_pipeline()
        self.traf.flush()
        if mode in ("spatial", "tiles") and self.cfg.cd_backend != "sparse":
            raise ValueError(
                f"SHARD {mode.upper()} needs the sparse backend "
                "(stripes/tiles are a property of the sorted schedule) "
                "— CDMETHOD SPARSE first")
        # leave the previous mode's table layout
        if self.shard_mode in ("spatial", "tiles") \
                and mode not in ("spatial", "tiles"):
            self.traf.state = shd.unprepare_spatial(self.traf.state)
        if mode == "off":
            self.shard_mode, self.shard_mesh = "off", None
            self.mesh_guard.set_mesh(None)
            self.cfg = self.cfg._replace(cd_mesh=None,
                                         cd_shard_mode="replicate",
                                         cd_tile_shape=(),
                                         cd_tile_budgets=())
            self._invalidate_sort()
            return True
        devs = list(devices) if devices is not None \
            else shd.default_devices(self.traf.device)
        ndev = ndev or len(devs)
        if ndev > len(devs):
            raise ValueError(f"SHARD: {ndev} devices requested, "
                             f"{len(devs)} available")
        if mode == "tiles":
            if tiles is None:
                cur = tuple(self.cfg.cd_tile_shape)
                tiles = cur if len(cur) == 2 and cur[0] * cur[1] == ndev \
                    else self._default_tile_shape(ndev)
            tiles = (int(tiles[0]), int(tiles[1]))
            if tiles[0] * tiles[1] != ndev:
                raise ValueError(
                    f"SHARD TILE {tiles[0]}x{tiles[1]} needs "
                    f"{tiles[0] * tiles[1]} devices, asked for {ndev}")
            mesh = shd.make_tile_mesh(tiles, devices=devs)
        else:
            mesh = shd.make_mesh(ndev, devices=devs)
        home, sdev = shd.home_device(mesh), self.traf.device
        if home.type != sdev.type or (home.index or 0) != (sdev.index or 0):
            raise ValueError(
                f"SHARD: the mesh's first device {home} must be the sim's "
                f"device {sdev} (the state stays whole there)")
        tile_budgets = ()
        block = min(self.cfg.cd_block, 256)
        if mode in ("spatial", "tiles"):
            t0 = time.perf_counter()
            if mode == "tiles":
                state, newslot, info = shd.prepare_tiles(
                    self.traf.state, mesh, self.cfg.asas, tiles=tiles,
                    block=block)
                tile_budgets = tuple(info["budgets"])
            else:
                state, newslot, info = shd.prepare_spatial(
                    self.traf.state, mesh, self.cfg.asas, block=block,
                    halo_blocks=halo_blocks)
                # pin the (auto-sized) halo the refresh validated
                halo_blocks = info["halo_blocks"]
            self._mesh_refresh_ms = (time.perf_counter() - t0) * 1e3
            self.traf.state = state
            self.traf.apply_slot_permutation(newslot)
            self.shard_stats = info
            self._sort_simt = self.simt
            self._sort_backend = "sparse"
            self._sort_t_chain = None   # the host value is the fresh truth
            self._last_edge = None      # slots moved: ACDATA cache stale
        else:
            self.traf.state = shd.shard_state(self.traf.state, mesh)
            self._invalidate_sort()
        self.shard_mode, self.shard_mesh = mode, mesh
        self.mesh_guard.set_mesh(mesh)
        self.cfg = self.cfg._replace(
            cd_mesh=mesh, cd_mesh_axis="ac",
            cd_shard_mode=mode if mode in ("spatial", "tiles")
            else "replicate",
            cd_halo_blocks=halo_blocks,
            cd_tile_shape=tiles if mode == "tiles" else (),
            cd_tile_budgets=tile_budgets)
        return True

    def _spatial_refresh(self, state):
        """The spatial/tiles chunk-edge refresh: re-sort, caller-slot
        re-bucketing and halo check, the host slot-table remap and the
        stats for SHARD.  A broken contract schedules the fallback at the
        next ``step()`` and steps this chunk on the old (still
        margin-covered) layout."""
        from ..core.asas import refresh_spatial_shard, refresh_tile_shard
        t0 = time.perf_counter()
        block = min(self.cfg.cd_block, 256)
        try:
            if self.shard_mode == "tiles":
                state, newslot, info = refresh_tile_shard(
                    state, self.cfg.asas, self.cfg.cd_tile_shape,
                    block=block, budgets=self.cfg.cd_tile_budgets)
            else:
                state, newslot, info = refresh_spatial_shard(
                    state, self.cfg.asas, self.shard_mesh.shape["ac"],
                    block=block, halo_blocks=self.cfg.cd_halo_blocks)
            self._mesh_refresh_ms = (time.perf_counter() - t0) * 1e3
        except RuntimeError as e:
            self.scr.echo(f"SHARD {self.shard_mode.upper()} contract "
                          f"violated: {e}")
            self._shard_fallback = True
            return state
        self.traf.apply_slot_permutation(newslot)
        self.shard_stats = info
        self._last_edge = None          # slots moved: ACDATA cache stale
        return state

    # ------------------------------------------------- mesh-epoch recovery
    def _handle_mesh_lost(self, err):
        """End the current mesh epoch after a lost group of shards and
        form the next one (JAX ``Simulation._handle_mesh_lost``).

        Record a ``mesh_lost`` trip in the guard's trip log; void the
        in-flight edge (it rode the dead mesh); take the restore point,
        the newest ring entry, else the on-disk autosave (its shard
        header read before anything is unpickled); leave the dead mesh;
        restore; form a smaller mesh of the survivors, degrading tiles ->
        spatial -> replicate -> one device until a layout holds; record
        the ``resharded`` trip, move to the next epoch and queue a
        MESHLOST notice for the owning node.  A restore onto another
        shard count resets the sorted-space caches
        (``snapshot.restore_blob``)."""
        from . import snapshot as snap
        old_epoch = self.mesh_epoch
        old_mode = self.shard_mode
        old_nd = self._shard_ndev()
        lost = list(getattr(err, "lost_groups", ()))
        survivors = list(getattr(err, "survivors", ()) or [])
        # the in-flight chunk rode the dead mesh: its edge is void
        if self._pending_edge is not None:
            self.recorder.instant(
                "chunk_voided", seq=self._pending_edge.seq,
                chunk=self._pending_edge.chunk, epoch=old_epoch,
                world=self.world_tag)
        self._pending_edge = None
        self._last_edge = None
        self.scr.echo(f"MESH LOST (epoch {old_epoch}): {err}")
        self.guard.mesh_trip("mesh_lost", epoch=old_epoch,
                             lost_groups=lost, ndev=old_nd,
                             mode=old_mode, error=str(err))
        blob = self.snap_ring.newest()
        src = "ring"
        if blob is None:
            path = self._autosave_path()
            if os.path.isfile(path):
                hdr, herr = snap.peek_shard(path)
                if herr:
                    self.scr.echo(f"mesh recovery: autosave header "
                                  f"unusable ({herr})")
                else:
                    if hdr is not None and hdr.get("ndev", 0) != old_nd:
                        self.scr.echo(
                            "mesh recovery: autosave captured on a "
                            f"{hdr.get('ndev')}-device "
                            f"{hdr.get('mode')} mesh — re-shard will "
                            "re-sort/re-bucket")
                    blob, rerr = snap.read_blob(path)
                    src = path
                    if blob is None:
                        self.scr.echo(f"mesh recovery: autosave "
                                      f"unusable ({rerr})")
        # epoch teardown: leave the dead mesh (the state stays on the
        # sim's device, the spatial tables unsized)
        try:
            self.set_shard("off")
        except (ValueError, RuntimeError) as e:  # pragma: no cover
            self.scr.echo(f"mesh teardown failed: {e}")
        restored = False
        if blob is not None:
            ok, msg = snap.restore_blob(self, blob, full_reset=False)
            restored = bool(ok)
            self.scr.echo(f"mesh recovery: {msg}" if ok else
                          f"mesh recovery restore FAILED: {msg}")
        else:
            self.scr.echo("mesh recovery: no checksummed snapshot — "
                          "re-sharding the live state")
        nd = len(survivors)
        new_mode = "off"
        if nd >= 1:
            if old_mode == "tiles":
                chain = ["tiles", "spatial", "replicate"]
            elif old_mode == "replicate":
                chain = ["replicate"]
            else:
                chain = [old_mode, "replicate"]
            for m in chain:
                try:
                    self.set_shard(m, nd, devices=survivors)
                    new_mode = m
                    break
                except (ValueError, RuntimeError) as e:
                    self.scr.echo(f"mesh recovery: SHARD "
                                  f"{m.upper()} {nd} failed ({e})")
        nd_now = self._shard_ndev(default=1)
        self.mesh_epoch = old_epoch + 1
        self.mesh_guard.epoch = self.mesh_epoch
        self.mesh_degraded = (new_mode != old_mode) or (nd_now < old_nd)
        self.guard.mesh_trip("resharded", epoch=self.mesh_epoch,
                             mode=new_mode, ndev=int(nd_now),
                             restored=restored,
                             restore_src=(src if blob is not None
                                          else None))
        self.scr.echo(
            f"MESH EPOCH {self.mesh_epoch}: "
            f"{new_mode.upper() if new_mode != 'off' else 'SINGLE-CHIP'}"
            f" on {nd_now} device(s)"
            + (" [degraded]" if self.mesh_degraded else "")
            + (f", restored from {src}" if restored else
               ", continuing on live state"))
        # the notice for the owning node -> server (MESHLOST): a
        # recovered epoch keeps its piece in flight (audit records only)
        self.mesh_events.append(dict(
            recovered=True, epoch=self.mesh_epoch,
            prev_epoch=old_epoch, lost_groups=lost,
            mode=new_mode, ndev=int(nd_now),
            prev_mode=old_mode, prev_ndev=int(old_nd),
            degraded=bool(self.mesh_degraded), restored=restored,
            simt=float(self.simt_planned)))

    def mesh_health(self):
        """The HEALTH ``mesh`` section: epoch, shard count, mode, last
        shard-refresh wall ms, degradation state."""
        d = dict(epoch=int(self.mesh_epoch), devices=self._shard_ndev(),
                 mode=str(self.shard_mode),
                 last_refresh_ms=round(float(self._mesh_refresh_ms), 3),
                 degraded=bool(self.mesh_degraded))
        if self.shard_mode == "tiles":
            ts = tuple(self.cfg.cd_tile_shape)
            d["tiles"] = f"{ts[0]}x{ts[1]}" if len(ts) == 2 else ""
            d["tile_budgets"] = list(self.cfg.cd_tile_budgets)
        return d

    # ----------------------------------------------------- preempt/autosave
    def request_preempt(self):
        """Raise the preemption flag (a signal handler's call): handled at
        the next chunk edge, so the chunk in flight drains instead of
        being torn."""
        self.preempt_requested = True
        return True

    def handle_preempt(self):
        """Answer a preemption notice: pause and write a final atomic
        checksummed checkpoint, ``preempt-<tag>.snap`` in
        ``settings.preempt_snapshot_dir`` (else the log path), the tag
        the owning node's id (8 hex digits), else the owning worker's
        ``host_tag``, else ``sim``, and, for a world of a packed batch,
        its ``world_tag``.  Returns ``(path or None,
        error or None)``."""
        from .. import settings as _settings
        from . import snapshot as snap
        self.preempt_requested = False
        d = _settings.preempt_snapshot_dir or _settings.log_path
        tag = getattr(getattr(self, "node", None), "node_id",
                      b"").hex()[:8] or self.host_tag or "sim"
        if self.world_tag:
            # one file per world: the worlds of one process must not
            # overwrite each other's checkpoints
            tag = f"{tag}-{self.world_tag}"
        path = os.path.join(d, f"preempt-{tag}.snap")
        self.pause()
        try:
            os.makedirs(d, exist_ok=True)
            snap.save(self, path)
        except OSError as e:
            self.scr.echo(f"preempt checkpoint FAILED: {e}")
            return None, str(e)
        self.scr.echo(f"preempted at simt={self.simt:.2f}: "
                      f"checkpoint written to {path}")
        return path, None

    def _autosave_path(self):
        from .. import settings as _settings
        return _settings.snapshot_autosave_path \
            or os.path.join(_settings.log_path, "autosave.snap")

    def _autosave(self):
        """Persist the newest snapshot-ring entry (or a fresh capture when
        the ring holds none newer than the last autosave) atomically: the
        on-disk checkpoint a preempted or killed process resumes from.  A
        failed write is an echo, never an exception out of the loop."""
        from . import snapshot as snap
        blob = self.snap_ring.newest()
        if blob is None or snap.blob_simt(blob) <= self._autosave_t:
            blob = snap.state_blob(self)
        path = self._autosave_path()
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            snap.write_blob(blob, path)
        except OSError as e:
            self.scr.echo(f"autosnapshot failed: {e}")
        self._autosave_t = self.simt

    def fastforward(self, nsec: Optional[float] = None):
        """FF [sec]: run at full speed [for nsec] (simulation.py:180-185)."""
        self.ffmode = True
        self.ffstop = self.simt + nsec if nsec else None
        return True

    def benchmark(self, fname: str = "IC", tend: float = 60.0):
        """BENCHMARK [scen, t]: load scenario, FF a span, report wall time
        (simulation.py:187-190, completion report :72-77)."""
        ok, msg = self.stack.ic(fname)
        if not ok:
            return False, msg
        self.bencht = 0.0
        self.benchdt = float(tend)
        self.fastforward(float(tend))
        self.op()
        return True

    # -------------------------------------------- differentiable workloads
    def optimize_trajectories(self, tend=None, iters=None, lr=None,
                              restarts=None, **kw):
        """Gradient-based trajectory optimization of the current fleet
        (the OPT stack command; ``diff/optimize.py``).

        Drains the pipeline and flushes pending creations so the
        optimizer sees the true state, descends on per-aircraft lateral
        waypoint / departure-time offsets against the soft-LoS and fuel
        objective, verifies against the hard metric, and records a guard
        trip (a non-finite forward step, objective or gradient) in the
        integrity guard's trip log.  Returns the ``OptResult``; the fleet
        is left as it was.
        """
        from .. import settings as _s
        from ..diff import optimize as diffopt

        def opt(name, given, default, cast=float):
            return cast(given if given is not None
                        else getattr(_s, name, default))
        self.drain_pipeline()
        self.traf.flush()
        result = diffopt.optimize(
            self.traf.state, self.cfg.asas,
            tend=opt("opt_tend", tend, 600.0),
            simdt=opt("opt_simdt", kw.pop("simdt", None), 1.0),
            chunk=opt("opt_chunk", kw.pop("chunk", None), 50, int),
            iters=opt("opt_iters", iters, 40, int),
            lr=opt("opt_lr", lr, 0.15),
            temp0=opt("opt_temp0", kw.pop("temp0", None), 0.3),
            temp1=opt("opt_temp1", kw.pop("temp1", None), 0.05),
            restarts=opt("opt_restarts", restarts, 1, int),
            los_margin=opt("opt_los_margin", kw.pop("los_margin", None),
                           1.2),
            verify_simdt=opt("opt_verify_dt", kw.pop("verify_simdt", None),
                             0.05),
            **kw)
        if result.bad != -1:
            # the backward-extended guard trip goes where forward trips go
            self.guard.trips.append({
                "simt": self.simt, "bad_step": int(result.bad),
                "ids": [], "action": "opt_halt",
                "source": "diff.optimize backward guard"})
            what = {diffopt.GUARD_BAD_GRADS: "non-finite gradients",
                    diffopt.GUARD_BAD_VALUE: "non-finite objective"}.get(
                        result.bad, "forward step")
            self.scr.echo(
                f"OPT: integrity-guard trip (word {result.bad}: {what})"
                " — descent halted at the last finite iterate")
        return result

    # ----------------------------------------------------------------- step
    def step(self, max_chunk: Optional[int] = None):
        """One host iteration: scenario triggers + stack + a device chunk.

        Mirrors the per-step order of simulation.py:62-128 at chunk
        granularity.  Returns False once END is reached.

        Pipelined stepping (default, ``settings.chunk_pipeline``): the
        next chunk is dispatched BEFORE the previous chunk's edge
        subsystems run, so host edge work (guard word, metrics, trails,
        snapshot capture) overlaps the chunk on the device.  Any edge
        that must read-modify the state — pending stack commands (incl.
        every scenario-trigger boundary), queued aircraft creations,
        armed conditionals, runway approach, due loggers/plots, FF stop,
        guard policy ``halt`` — retires the deferred edge first and
        steps synchronously, bit-identically to the unpipelined loop.
        """
        if self.state_flag == END:
            return False
        plan = self._plan_chunk(max_chunk)
        if plan is None:
            return True
        chunk, simt = plan
        from ..parallel.sharding import MeshLostError
        try:
            reasons = self._sync_reasons(simt, chunk)
            if reasons:
                self._retire_edge(reasons[0])
                # every co-occurring cause counts
                sync_hist = self.pipe_stats["sync_reasons"]
                for r in reasons:
                    sync_hist[r] = sync_hist.get(r, 0) + 1
                self._step_sync(chunk, self.simt)
            else:
                self._step_pipelined(chunk, simt)
        except MeshLostError as e:
            # a group of shards died: end the mesh epoch, not the run
            self._handle_mesh_lost(e)
        self._after_chunk()
        return True

    def _plan_chunk(self, max_chunk: Optional[int] = None):
        """The host pre-chunk phase of ``step()``: process the stack,
        decide whether a device chunk runs this iteration and how long
        it is.  Returns ``(chunk, simt)`` ready for dispatch, or
        ``None`` when this iteration is already handled without a chunk
        (HOLD, FF horizon reached, stack-only work)."""
        if self._shard_fallback:
            self._shard_fallback = False
            nd = self._shard_ndev()
            if self.shard_mode == "tiles":
                # one rung at a time: stripes keep the O(N/D) schedule if
                # their contract holds; only then the replicated floor
                try:
                    self.scr.echo("SHARD: falling back to SPATIAL "
                                  f"({nd} devices)")
                    self.set_shard("spatial", nd, devices=self._mesh_devs())
                except (ValueError, RuntimeError) as e:
                    self.scr.echo(f"SHARD: SPATIAL fallback failed ({e}); "
                                  f"falling back to REPLICATE ({nd} "
                                  "devices)")
                    self.set_shard("replicate", nd,
                                   devices=self._mesh_devs())
            else:
                self.scr.echo("SHARD: falling back to REPLICATE "
                              f"({nd} devices)")
                self.set_shard("replicate", nd, devices=self._mesh_devs())
        # External TCP/telnet command lines (network/tcpserver.py)
        if self.telnet is not None:
            self.telnet.pump()
        # Scenario commands due at current sim time (stack.checkfile).
        simt = self.simt_planned
        self.stack.checkfile(simt)
        # Process pending commands (may change state/config/traffic).
        # Commands observe and mutate the post-chunk state, so the
        # deferred edge retires first — this IS the trigger-boundary /
        # stack-command synchronous fallback.
        if self.stack.cmdstack:
            self._retire_edge("stack")
            self.stack.process()
            simt = self.simt_planned    # RESET/IC may move the clock

        if self.state_flag == INIT and self.traf.ntraf > 0:
            self.op()   # auto-start like simulation.py:89-98

        if self.state_flag != OP:
            self._retire_edge("hold")
            return None

        # FAULT STRAGGLE STALL: skip the device chunk; simt freezes while
        # the host loop keeps pumping events, so progress heartbeats flow
        # with a flat simt (what the server's straggler detector hedges)
        if self.straggle_stall:
            time.sleep(0.02)
            return None

        # FAULT STRAGGLE <factor>: pay the throttle debt in small slices,
        # one per host iteration, so the slow worker keeps heartbeating
        # (a chunk-sized sleep would make it look dead, not slow)
        if self._straggle_debt > 0:
            pay = min(self._straggle_debt, 0.05)
            self._straggle_debt -= pay
            time.sleep(pay)
            return None

        # Benchmark bookkeeping
        if self.benchdt > 0.0 and self.bencht == 0.0:
            self.bencht = time.perf_counter()

        if self.traf._pending:
            # queued aircraft creations write into the state tensors:
            # retire the deferred edge, then apply them (sync fallback)
            self._retire_edge("flush")
        self.traf.flush()

        # Determine the chunk: stop exactly at the next scenario trigger,
        # quantized to a small ladder (each chunk length is one more
        # set of captured graphs on the card).
        if max_chunk is not None:
            chunk = max_chunk        # explicit caller bound (run horizon)
        else:
            chunk = self.chunk_steps
            if self.ffmode:
                chunk = max(chunk, 1000)
        limit = chunk
        # Subsystem dt clamps (conditionals <= 1 s, trail resolution,
        # plots, metrics), run as EXACT step counts.
        dtclamp = None
        if self.cond.ncond > 0:
            dtclamp = max(1, int(round(1.0 / self.cfg.simdt)))
        # Landing detection samples at ~1 s once an aircraft is near its
        # threshold (see _runway_approach_active for the gate radius).
        self._rwy_near = self._runway_approach_active()
        if self._rwy_near:
            c = max(1, int(round(1.0 / self.cfg.simdt)))
            dtclamp = c if dtclamp is None else min(dtclamp, c)
        if self.traf.trails.active:
            c = max(1, int(round(self.traf.trails.dt / self.cfg.simdt)))
            dtclamp = c if dtclamp is None else min(dtclamp, c)
        plugdt = self.plugins.min_dt()
        if plugdt is not None:
            c = max(1, int(round(plugdt / self.cfg.simdt)))
            dtclamp = c if dtclamp is None else min(dtclamp, c)
        if self.plotter.plots:
            pdt = min(p.dt for p in self.plotter.plots)
            c = max(1, int(round(pdt / self.cfg.simdt)))
            dtclamp = c if dtclamp is None else min(dtclamp, c)
        if self.metrics.metric_number >= 0:
            c = max(1, int(round(self.metrics.dt / self.cfg.simdt)))
            dtclamp = c if dtclamp is None else min(dtclamp, c)
        if dtclamp is not None:
            limit = min(limit, dtclamp)
        tnext = self.stack.next_trigger_time()
        if tnext is not None:
            steps_to_trigger = int(np.ceil(
                max(0.0, tnext - simt) / self.cfg.simdt + 1e-9))
            if steps_to_trigger > 0:
                limit = min(limit, steps_to_trigger)
        if self.ffstop is not None:
            steps_to_stop = int(round((self.ffstop - simt) / self.cfg.simdt))
            if steps_to_stop <= 0:
                self._end_ff()
                return None
            limit = min(limit, steps_to_stop)
        # Quantize to the ladder — EXCEPT when the binding constraint is
        # a dt clamp, which runs exactly.  A CHUNKSTEPS value off the
        # ladder joins it.
        ladder = self.CHUNK_LADDER
        if self.chunk_steps not in ladder:
            ladder = tuple(sorted(set(ladder) | {int(self.chunk_steps)},
                                  reverse=True))
        chunk = 1
        for c in ladder:
            if c <= limit:
                chunk = c
                break
        if dtclamp is not None and limit == dtclamp \
                and dtclamp < self.CHUNK_LADDER[-3] and chunk < limit:
            chunk = limit

        # Wall-clock pacing (skipped in fast-forward), simulation.py:67-70
        if not self.ffmode and self.dtmult <= 1.0 and self.syst >= 0:
            now = time.perf_counter()
            if now < self.syst:
                time.sleep(self.syst - now)
        if self.syst < 0:
            self.syst = time.perf_counter()
        self.syst += chunk * self.cfg.simdt / max(self.dtmult, 1e-9)

        # Plugin preupdate hooks fire before the device chunk
        # (simulation.py:83); they may read/mutate state, so a due hook
        # retires the deferred edge first
        if self.plugins.has_due(simt):
            self._retire_edge("plugin")
            self.plugins.preupdate(simt)
            self.traf.flush()   # preupdate hooks may have queued aircraft
            # plugin hooks may mutate traffic DIRECTLY (traf.delete/
            # create) without a stack command, so the ACDATA edge cache
            # cannot be trusted past them
            self._last_edge = None
        return chunk, simt

    def _after_chunk(self):
        """Post-dispatch horizon check."""
        if self.ffstop is not None \
                and self.simt_planned >= self.ffstop - 1e-9:
            self._end_ff()
        # rate-limited Prometheus text dump (metrics_export_path knob;
        # no-op when unset) and the throttled memory sample
        # (devprof_mem_dt knob; off by default)
        self.obs.maybe_export()
        self.devprof.sample_memory()

    # ------------------------------------------------- chunk dispatch/edges
    def _sync_reasons(self, simt: float, chunk: int):
        """Why the upcoming chunk edge cannot be deferred (empty list =
        safe to pipeline).  Every reason is a subsystem that reads or
        mutates the post-chunk state on the host at that edge."""
        reasons = []
        if not self.pipeline_enabled:
            reasons.append("off")
        t_edge = self._fold_clock(simt, chunk)
        if self.cond.ncond > 0:
            reasons.append("cond")          # ATALT/ATSPD sample + fire
        if self._rwy_near:
            reasons.append("runway")        # landing chain reads state
        if self.plotter.plots:
            reasons.append("plot")          # PLOT samples live attrs
        if self.plugins.has_due(t_edge):
            reasons.append("plugin")        # update hook at the edge
        if self.datalog.any_due(t_edge):
            reasons.append("datalog")       # periodic logger samples
        if self.ffstop is not None and t_edge >= self.ffstop - 1e-9:
            reasons.append("ff-stop")       # _end_ff timing boundary
        if self.preempt_requested:
            reasons.append("preempt")       # drain + checkpoint next
        if self.guard.enabled and self.guard.policy == "halt":
            reasons.append("guard-halt")    # halt wants the tripped
            #                                 state frozen at its edge
        if self.autosave_dt > 0 \
                and t_edge - self._autosave_t >= self.autosave_dt - 1e-9:
            reasons.append("autosave")      # on-disk persist reads state
        if self.shard_mode in ("spatial", "tiles") \
                and self._refresh_due(simt):
            reasons.append("shard-refresh")  # the re-bucketing moves the
            #                                  slots the pending edge uses
        return reasons

    def _dispatch_chunk(self, state, chunk: int, keep: bool, simt: float):
        """Enqueue the (due) spatial-sort refresh and the chunk
        back-to-back, with no host read between them.  Returns
        ``(state, telemetry, stats, refresh, fingerprint)``: ``stats``
        the ScanStats pack when ``cfg.scanstats``, ``refresh`` the
        RefreshPack when the in-chunk refresh rides, ``fingerprint`` the
        FingerprintPack when ``cfg.fingerprint`` (None otherwise).

        ``keep=True`` selects the runner that leaves its input intact
        (``run_steps_edge_keep``): the caller needs the *input* state
        to stay valid (snapshot-ring capture of the post-chunk state
        while the next chunk runs)."""
        rec = self.recorder
        t0 = time.perf_counter()
        if self._last_dispatch_end is not None:
            self.obs.get("sim_dispatch_gap_ms").observe(
                (t0 - self._last_dispatch_end) * 1e3)
        seq = self._next_seq()
        with rec.span("chunk_dispatch", seq=seq, chunk=chunk, simt=simt,
                      world=self.world_tag, epoch=self.mesh_epoch):
            # the mesh-epoch precheck: a dead group of shards (FAULT
            # MESHKILL) surfaces BEFORE the chunk is enqueued onto the
            # dead mesh, as a MeshLostError that step() hands to
            # _handle_mesh_lost
            if self.shard_mesh is not None and self.mesh_guard_enabled:
                with rec.span("mesh_check", seq=seq, epoch=self.mesh_epoch,
                              world=self.world_tag):
                    self.mesh_guard.check()
            dp = self.devprof
            win = dp.begin_chunk(seq)
            t_h0 = time.perf_counter() if win else 0.0
            state = self._pre_dispatch_refresh(state, simt)
            halo_s = (time.perf_counter() - t_h0) if win else 0.0
            from ..core import graph
            from ..core.step import run_steps_edge, run_steps_edge_keep
            runner = run_steps_edge_keep if keep else run_steps_edge
            inscan = self._inscan_refresh_active()
            sort_t0 = self._sort_t0_for_dispatch(state) if inscan \
                else None
            if win:
                dp.fence(state.device)
                t_c0 = time.perf_counter()
            misses = graph.misses()
            out = runner(state, self.cfg, chunk,
                         checked=self.guard.enabled, sort_t0=sort_t0)
            if win:
                # the compute section needs the device fence: the few
                # windowed chunks serialize the pipeline (PROFILE DEVICE)
                dp.fence(state.device)
                dp.note_chunk(seq, chunk,
                              (time.perf_counter() - t_c0) * 1e3,
                              halo_s * 1e3)
                if not keep:
                    dp.check_donation(state, out[0])
            # the graph pool made a new executor: a compile miss
            dp.note_dispatch(
                ("edge_keep" if keep else "edge")
                + ("+checked" if self.guard.enabled else ""),
                chunk, self.traf.nmax, self._shard_ndev(default=1),
                graph.misses() > misses)
        self._last_dispatch_end = time.perf_counter()
        # Normalized return: the runner's output arity follows the cfg
        # flags (core/step._edge: stats before refresh before
        # fingerprint); the callers always see five.
        rest = list(out[2:])
        sstats = rest.pop(0) if self.cfg.scanstats else None
        rpack = rest.pop(0) if inscan else None
        fpack = rest.pop(0) if self.cfg.fingerprint else None
        if rpack is not None:
            # chain the due gate: the NEXT dispatch takes this chunk's
            # final sort_t (a host scalar)
            self._sort_t_chain = rpack.sort_t
            self._sort_backend = self.cfg.cd_backend
        return out[0], out[1], sstats, rpack, fpack

    def _next_seq(self) -> int:
        """Bump and return the host-side chunk-sequence correlation tag:
        one per dispatched chunk, stamped onto the ChunkEdge and every
        span of that chunk."""
        self._chunk_seq += 1
        self._seq_dispatched = self._chunk_seq
        return self._chunk_seq

    def _refresh_due(self, simt: float) -> bool:
        """Whether the next dispatch runs the host-edge sort refresh: a
        blockwise backend without the in-chunk refresh, and the cadence
        elapsed, no sort yet, or a backend switch ('sparse' stores
        stripe DESTINATIONS in sort_perm, the others a Morton
        PERMUTATION: feeding one into the other scrambles the layout)."""
        if self._inscan_refresh_active() \
                or self.cfg.cd_backend not in ("tiled", "pallas", "sparse"):
            return False
        due = self.cfg.asas.sort_every * self.cfg.asas.dtasas
        return (simt - self._sort_simt >= due or self._sort_simt < 0
                or self._sort_backend != self.cfg.cd_backend)

    def _pre_dispatch_refresh(self, state, simt: float):
        """The (due) chunk-edge spatial-sort refresh (in the spatial and
        tiles modes the shard refresh, ``_spatial_refresh``).  With the
        in-chunk refresh active this is a NO-OP (the refresh rides the
        chunk and retires via the RefreshPack)."""
        if self._refresh_due(simt):
            t0 = time.perf_counter()
            with self.recorder.span("sort_refresh",
                                    backend=self.cfg.cd_backend,
                                    shard=self.shard_mode,
                                    world=self.world_tag):
                if self.shard_mode in ("spatial", "tiles"):
                    state = self._spatial_refresh(state)
                else:
                    from ..core.asas import impl_for_backend, \
                        refresh_spatial_sort
                    state = refresh_spatial_sort(
                        state, self.cfg.asas,
                        block=self.cfg.cd_block,
                        impl=impl_for_backend(self.cfg.cd_backend))
            self.obs.get("sim_sort_refresh_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            self._sort_simt = simt
            self._sort_backend = self.cfg.cd_backend
        return state

    def _fold_clock(self, t0: float, chunk: int) -> float:
        """Predict the clock after ``chunk`` steps by folding the
        per-step additions in the state's own float dtype — bit-exact
        emulation of the chunk runner's ``simt + simdt`` chain (strictly
        sequential rounding, as ``np.add.accumulate`` applies it)."""
        dt_np = self.traf.state.simt.dtype
        chain = np.empty(chunk + 1, dt_np)
        chain[0] = t0
        chain[1:] = np.asarray(self.cfg.simdt, dt_np)
        return float(np.add.accumulate(chain)[-1])

    def _step_pipelined(self, chunk: int, simt: float):
        """Double-buffered dispatch: enqueue the next chunk, THEN retire
        the previous chunk's edge off its telemetry pack while the new
        chunk runs on the device."""
        pend = self._pending_edge
        ring = self.snap_ring
        # Will retiring the pending edge capture a restore point?  Then
        # this dispatch must NOT donate its input: it is exactly the
        # post-chunk state that goes into the ring.  The captures feed
        # the rollback policy AND the mesh-epoch recovery: under a mesh
        # the ring keeps filling whatever the guard policy, or a lost
        # group would leave nothing to re-shard from.
        capture_due = (ring.dt > 0
                       and simt - ring.t_last >= ring.dt - 1e-9)
        capture_now = (pend is not None and capture_due
                       and ((self.guard.enabled
                             and self.guard.policy == "rollback")
                            or self.shard_mode != "off"))
        state_in = self.traf.state
        new_state, telem, sstats, rpack, fpack = self._dispatch_chunk(
            state_in, chunk, keep=capture_now, simt=simt)
        self.traf.state = new_state
        self._step_count += chunk
        self._straggle_charge(chunk)
        self._simt_next = self._fold_clock(simt, chunk)
        self._pending_edge = ChunkEdge(telem, chunk,
                                       simt_planned=self._simt_next,
                                       seq=self._seq_dispatched,
                                       obs_sink=self._edge_pull_sink,
                                       stats=sstats, refresh=rpack,
                                       fingerprint=fpack)
        self.pipe_stats["pipelined_chunks"] += 1
        if pend is not None:
            self._finish_edge(
                pend, capture_state=state_in if capture_now else None)

    def _step_sync(self, chunk: int, simt: float):
        """The synchronous chunk: dispatch, wait for the guard word,
        then run every edge subsystem against the live state."""
        self.pipe_stats["sync_chunks"] += 1
        state, telem, sstats, rpack, fpack = self._dispatch_chunk(
            self.traf.state, chunk, keep=False, simt=simt)
        self._apply_chunk_result(state, telem, chunk, stats=sstats,
                                 refresh=rpack, fingerprint=fpack)

    def _apply_chunk_result(self, state, telem, chunk: int,
                            seq: Optional[int] = None, stats=None,
                            refresh=None, fingerprint=None):
        """Install one synchronously-completed chunk's result and run
        every edge subsystem against it — the post-dispatch half of
        ``_step_sync``."""
        self.traf.state = state
        self._step_count += chunk
        self._straggle_charge(chunk)
        if seq is None:
            seq = self._seq_dispatched
        edge = ChunkEdge(telem, chunk,      # device clock, no prediction
                         seq=seq, obs_sink=self._edge_pull_sink,
                         stats=stats, refresh=refresh,
                         fingerprint=fingerprint)
        t_ret0 = time.perf_counter()
        # Retire the in-chunk refresh pack FIRST (before the guard
        # response and every edge consumer).
        self._retire_refresh(edge)
        tripped = False
        if self.guard.enabled:
            # Integrity-guarded chunk: the isfinite check rides the
            # chunk's carry and pins a trip to one step of the chunk;
            # the guard then quarantines or rolls back at this edge.
            bad = edge.bad_step
            if bad >= 0:
                self.guard.trip(bad, chunk)
                tripped = True
        # Publish the edge to the ACDATA cache only when its pack still
        # describes the live state: a trip just scrubbed/rolled back the
        # fleet, so the tripped pack must never reach the stream.
        self._last_edge = None if tripped else edge
        # Drain the in-chunk stats pack only off a CLEAN edge.
        if not tripped:
            self._drain_scanstats(edge)
            self._drain_fingerprint(edge)

        plugins_due = self.plugins.has_due(self.simt)

        # Chunk-edge subsystems: plugin updates, conditional triggers,
        # trails, loggers (the reference runs these per 0.05 s step,
        # simulation.py:110-116; here they sample the chunk-edge state)
        self.plugins.update(self.simt)
        self.traf.flush()
        self.cond.update()
        self._check_runway_landings()
        self.plotter.update(self.simt)
        self.metrics.update()
        if self.traf.trails.active:
            # inactive trails only re-anchor, and TRAIL ON anchors anew
            self.traf.trails.update(self.simt)
        self.datalog.postupdate(self)
        if plugins_due:
            # plugin hooks can mutate traffic directly, past the cache
            self._last_edge = None

        # Periodic snapshot-ring capture: the post-chunk state is
        # verified finite when the guard is on, so ring entries are
        # always healthy restore points.  The rollback policy and the
        # mesh-epoch recovery consume the ring, and a capture is a full
        # device->host copy of the state, so other runs do not pay it.
        if self.state_flag == OP and (
                (self.guard.enabled and self.guard.policy == "rollback")
                or self.shard_mode != "off"):
            self.snap_ring.maybe_capture(self)

        # Periodic on-disk autosnapshot (snapshot_autosave_dt, off by
        # default): persist the newest ring entry, or a fresh capture,
        # with the atomic checksummed writer, so a later preemption or
        # kill resumes from here.
        if self.autosave_dt > 0 and self.state_flag == OP \
                and self.simt - self._autosave_t \
                >= self.autosave_dt - 1e-9:
            self._autosave()
        self._edge_retired(edge, t_ret0)

    def _straggle_charge(self, chunk: int):
        """FAULT STRAGGLE <factor>: each simulated second owes ``factor``
        extra wall seconds, paid in slices by ``_plan_chunk``."""
        if self.straggle_factor > 0:
            self._straggle_debt += \
                chunk * self.cfg.simdt * self.straggle_factor

    def _finish_edge(self, edge, capture_state=None):
        """Retire one DEFERRED chunk edge: poll the guard word (the
        completion fence), respond to a late trip, then run the passive
        edge consumers off the telemetry pack.  Runs while the next
        chunk computes on the device."""
        t_ret0 = time.perf_counter()
        self._retire_refresh(edge)
        bad = edge.bad_step
        if self.guard.enabled and bad >= 0:
            self._deferred_trip(edge, bad)
            return
        # Passive consumers: each samples the edge state from the pack.
        self._drain_scanstats(edge)
        self._drain_fingerprint(edge)
        self.metrics.update(edge)
        if self.traf.trails.active:
            pack = edge.fetch()
            self.traf.trails.update(edge.simt,
                                    np.asarray(pack.lat),
                                    np.asarray(pack.lon),
                                    active=np.asarray(pack.active))
        # Snapshot-ring capture of the kept (not donated) post-chunk
        # state while the next chunk is in flight; the runners return
        # that state to no one else, so its buffers are free after it.
        if capture_state is not None:
            self.snap_ring.capture(self, state=capture_state,
                                   simt=edge.simt)
            from ..core import graph
            graph.release(capture_state)
        self._last_edge = edge
        self._edge_retired(edge, t_ret0)

    def _drain_scanstats(self, edge):
        """Drain one clean edge's in-chunk accumulator pack (host
        arrays) into the registry and the HEALTH summary.  No-op when
        the edge carries no pack."""
        if edge.stats is None:
            return
        from ..obs import scanstats as ssmod
        t0 = time.perf_counter()
        summary = ssmod.drain(self.obs, edge.stats)
        self._scan_last = summary
        rec = self.recorder
        if rec.enabled:
            rec.complete("scanstats", rec.wall_us(t0),
                         (time.perf_counter() - t0) * 1e6,
                         seq=edge.seq, chunk=edge.chunk,
                         conf_peak=summary.get("conf_peak"),
                         min_sep_m=summary.get("min_sep_m"),
                         clamp_sat_ratio=summary.get("clamp_sat_ratio"))

    def _edge_retired(self, edge, t_ret0: float):
        """Book one retired edge into the registry + recorder: the
        chunk-latency series and a chunk_edge span covering the
        retirement work itself."""
        now = time.perf_counter()
        self.obs.get("sim_chunk_latency_ms").observe(
            (now - edge.t_dispatch) * 1e3)
        self.devprof.note_edge(edge.seq, (now - t_ret0) * 1e3)
        rec = self.recorder
        if rec.enabled:
            rec.complete("chunk_edge", rec.wall_us(t_ret0),
                         (now - t_ret0) * 1e6,
                         seq=edge.seq, chunk=edge.chunk,
                         latency_ms=round(
                             (now - edge.t_dispatch) * 1e3, 3))

    def _deferred_trip(self, edge, bad: int):
        """A guard word that came back tripped one chunk LATE: the fleet
        has already advanced into the next chunk, computed from the
        poisoned state.  Drop the in-flight edge and run the guard
        response against the CURRENT state — ``rollback`` restores a
        pre-fault ring entry exactly as in the synchronous path;
        ``quarantine`` deletes every aircraft non-finite NOW.  ``halt``
        never defers (guard-halt is a sync fallback reason)."""
        pend = self._pending_edge
        if pend is not None:
            self._retire_refresh(pend)
        self._pending_edge = None
        self._last_edge = None
        self.pipe_stats["deferred_trips"] += 1
        rec = self.guard.trip(int(bad), edge.chunk)
        if isinstance(rec, dict):
            rec["deferred"] = True
            rec["detect_lag_chunks"] = 1

    def _retire_edge(self, reason: str = "sync"):
        """Synchronization point: finish the deferred edge work of the
        in-flight chunk (if any) before host code reads or mutates the
        state.  Reentrancy-guarded because edge work itself (guard
        rollback -> reset_traffic) drains."""
        if self._pending_edge is None or self._retiring:
            return
        self._retiring = True
        try:
            edge, self._pending_edge = self._pending_edge, None
            self._finish_edge(edge, capture_state=None)
            # The retired edge state IS the live state again (nothing
            # was dispatched after it), so a due ring capture can use
            # the classic path at this sync boundary.
            if self.state_flag == OP and (
                    (self.guard.enabled and self.guard.policy == "rollback")
                    or self.shard_mode != "off"):
                self.snap_ring.maybe_capture(self)
        finally:
            self._retiring = False

    def drain_pipeline(self):
        """Public alias: block until no chunk is in flight and all edge
        work has run (callers: tests, snapshots)."""
        self._retire_edge("drain")
        return True

    def _runway_approach_active(self) -> bool:
        """Any unlanded runway-destination aircraft within its landing
        gate?  Cheap host flat-earth test — gates the 1 s landing
        sampling clamp so cruise fast-forward keeps long chunks.

        The gate radius is per-aircraft: threshold proximity guard plus
        the worst one-chunk travel at that aircraft's actual ground
        speed (floored at 340 m/s).

        While a pipelined chunk is in flight, the test samples the last
        RETIRED edge's telemetry pack instead of the live state (a read
        of the live state would wait for the chunk in flight).  The pack
        is up to one extra chunk stale, so the gate widens by one more
        chunk of worst-case travel."""
        cands = self.routes.runway_final_slots()
        if not cands:
            return False
        edge = self._last_edge if self._pending_edge is not None else None
        if edge is not None:
            pack = edge.fetch()
            lat = np.asarray(pack.lat)
            lon = np.asarray(pack.lon)
            gs = np.asarray(pack.gs)
            staleness = 2.0        # [chunks] covered by the gate radius
        else:
            st = self.traf.state
            lat = asnumpy(st.ac.lat)
            lon = asnumpy(st.ac.lon)
            gs = asnumpy(st.ac.gs)
            staleness = 1.0
        chunk_s = staleness * self.CHUNK_LADDER[0] * self.cfg.simdt
        # Worst-case acceleration cushion over one unclamped chunk.
        accel_cushion = 2.0 * chunk_s
        for slot, r in cands:
            if self.traf.ids[slot] is None:
                continue
            last = r.nwp - 1
            gate_nm = 5.0 + chunk_s * (
                max(340.0, float(gs[slot]) + accel_cushion)) / 1852.0
            dlat = lat[slot] - r.lat[last]
            dlon = (lon[slot] - r.lon[last]) * np.cos(np.radians(r.lat[last]))
            if np.hypot(dlat, dlon) * 60.0 <= gate_nm:
                return True
        return False

    def _check_runway_landings(self):
        """Runway-landing chain (reference route.py getnextwp:741-775).

        When the device FMS has reached an aircraft's FINAL waypoint and
        that waypoint is a runway threshold (DEST/ADDWPT ``APT/RWNN``),
        issue the reference's landing command sequence: hold the runway
        heading, decelerate after 10 s, delete after 42 s.  Runs at chunk
        edges; a 3 nm proximity guard distinguishes "reached the
        threshold" from a manual LNAV OFF far from the field.
        """
        # The pre-chunk gate proves nobody can be near a threshold this
        # chunk — skip the device transfers entirely for the cruise phase.
        if not getattr(self, "_rwy_near", True):
            return
        cands = self.routes.runway_final_slots()
        if not cands:
            return
        st = self.traf.state
        swlnav = asnumpy(st.ac.swlnav)
        iact = asnumpy(st.route.iactwp)
        lat = asnumpy(st.ac.lat)
        lon = asnumpy(st.ac.lon)
        fired = False
        for slot, r in cands:
            acid = self.traf.ids[slot]
            last = r.nwp - 1
            if acid is None or iact[slot] < last or swlnav[slot]:
                continue
            dlat = lat[slot] - r.lat[last]
            dlon = (lon[slot] - r.lon[last]) * np.cos(np.radians(r.lat[last]))
            if np.hypot(dlat, dlon) * 60.0 > 3.0:     # [nm] proximity guard
                continue
            # Runway heading from the threshold database when known, else
            # the final leg bearing (same number the FMS flew)
            apt, _, rwy = r.name[last].partition("/")
            thr = self.navdb.getrwythreshold(apt, rwy) if rwy else None
            if thr is not None:
                hdg = thr[2]
            elif last > 0:
                from ..ops import hostgeo
                hdg = float(hostgeo.qdrdist(
                    r.lat[last - 1], r.lon[last - 1],
                    r.lat[last], r.lon[last])[0]) % 360.0
            else:
                hdg = float(st.ac.trk[slot])
            r.flag_landed = True
            fired = True
            self.stack.stack(f"HDG {acid} {hdg:.1f}")
            self.stack.stack(f"DELAY 10 SPD {acid} 10")
            self.stack.stack(f"DELAY 42 DEL {acid}")
        if fired:
            self.stack.process()

    def _end_ff(self):
        self.ffmode = False
        self.ffstop = None
        if self.benchdt > 0.0:
            wall = time.perf_counter() - self.bencht
            self.scr.echo(
                f"Benchmark complete: {wall:.3f} s wall for "
                f"{self.benchdt:.1f} s sim ({self.benchdt / max(wall, 1e-9):.1f}x)")
            self.benchdt = -1.0
        self.pause()

    def run(self, until_simt: Optional[float] = None, max_iters: int = 10 ** 9):
        """Drive step() until END/HOLD or a sim-time horizon.

        Horizon math uses the planned clock so the loop itself never
        waits for the device; the pipeline drains before returning so
        callers observe a fully-retired state."""
        it = 0
        while it < max_iters:
            it += 1
            mc = None
            if until_simt is not None:
                remaining = until_simt - self.simt_planned
                if remaining <= 1e-9:
                    break
                # stop exactly at the horizon (ladder-quantized downstream)
                mc = max(1, int(round(remaining / self.cfg.simdt)))
            alive = self.step(max_chunk=mc)
            if self.preempt_requested:
                # embedded-run preemption: checkpoint and pause here
                self.handle_preempt()
                break
            if not alive or self.state_flag in (HOLD, END):
                if self.state_flag == HOLD and until_simt is not None \
                        and self.simt_planned < until_simt - 1e-9:
                    break
                if self.state_flag != OP:
                    break
        self.drain_pipeline()
        return self.simt
