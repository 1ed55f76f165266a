"""The settings the port reads: a copy of the ``bluesky_tpu.settings``
values its modules use, with the JAX defaults (the port imports nothing
from the JAX package), and JAX's two-level scheme: a config file
(``init``) plus per-module registered defaults
(``set_variable_defaults``).  The config file is a restricted ``key =
value`` file, each value read with ``ast.literal_eval``; unknown keys are
kept so that modules registering defaults later still pick them up.

Two keys JAX lacks.  ``device``, the port's device policy at the
command line: ``None`` (the default) is
``bluesky_tpu_torch.resolve_device``'s, CUDA or an error when there is
none; ``device = 'cpu'`` in a config file runs the worker on the CPU.
``config_file``, set by ``init``: the absolute path of the file loaded,
which the server hands to the workers it spawns (``--config-file``), so
they run on the server's device.

Every path is relative to the working directory: the port reads and
writes nothing outside its checkout.  Without a ``data/performance``
directory ``Traffic`` uses the built-in coefficient tables; without
``data/navdata`` the navigation database is the built-in world set.
"""
import ast
import os
import sys

from .network.common import DEFAULT_PORTS

simdt = 0.05
chunk_steps = 20                  # interactive chunk length in steps
                                  # (1 s sim time at simdt=0.05);
                                  # CHUNKSTEPS stack command at runtime
chunk_pipeline = True             # dispatch chunk k+1 before chunk k's
                                  # edge work (simulation/sim.py)
performance_model = "openap"
data_path = "data"
perf_path = os.path.join(data_path, "performance")
navdata_path = os.path.join(data_path, "navdata")
cache_path = os.path.join(data_path, "cache")
# ``python -m bluesky_tpu_torch --import-navdata <dir>`` copies a
# reference-format navdata tree here; it backs deployments without a
# navdata directory
imported_navdata_path = os.path.join(cache_path, "navdata")
if not os.path.isdir(navdata_path) and os.path.isdir(imported_navdata_path):
    navdata_path = imported_navdata_path
log_path = "output"
scenario_path = "scenario"
ref_scenario_path = ""            # a second scenario library, searched
                                  # after scenario_path ("" = none)
plugin_path = "plugins"           # plugin files beside the shipped ones
enabled_plugins = ["datafeed"]    # loaded by every Simulation (a name
                                  # that is not found is skipped)

device = None                     # the worker's torch device (None:
                                  # CUDA, or an error without one)

config_file = ""                  # the config file init() loaded
                                  # (absolute; "" = none)

# ----- network: the server's client-facing ports, the worker-facing
# ports a worker connects to, and the discovery port
event_port = DEFAULT_PORTS["event"]
stream_port = DEFAULT_PORTS["stream"]
wevent_port = DEFAULT_PORTS["wevent"]
wstream_port = DEFAULT_PORTS["wstream"]
discovery_port = DEFAULT_PORTS["discovery"]
max_nnodes = os.cpu_count() or 1  # workers a server spawns at most
telnet_port = 8888                # raw-TCP stack bridge of --sim and
                                  # --detached (0 = off)
node_watchdog_warn = 30.0         # [s] event-loop silence before warning
node_watchdog_kill = 0.0          # [s] silence before exit(70); 0 = never
stream_sndhwm = 1000              # [msgs] send buffer bound of a node's
                                  # and the server's stream sockets
                                  # (drops, never blocks)
connect_backoff_base = 0.25       # [s] first client connect retry delay
connect_backoff_cap = 4.0         # [s] backoff ceiling (jitter on top)

# ----- the server's BATCH farm (network/server.py): circuit breaker,
# heartbeats, stragglers and hedging, admission control
batch_max_crashes = 3             # consecutive worker losses before a
                                  # BATCH piece is circuit-broken
quarantine_report_cap = 64        # BATCHQUARANTINE replay history kept
                                  # for late-joining clients
hb_busy_multiplier = 10.0         # [x hb_timeout] PING-silence budget for
                                  # a worker mid-BATCH / in OP (a first
                                  # kernel build or a long chunk blocks
                                  # its event loop)
straggler_timeout = 30.0          # [s] fresh heartbeats but no sim-time/
                                  # chunk advance on an in-flight piece
                                  # before it is hedged (0 = never)
hedge_enabled = True              # speculative straggler re-dispatch
hedge_rate_factor = 0.2           # also hedge when a worker's progress
                                  # rate < factor * fleet median
perf_slo_factor = 0.0             # journal a perf_regression record when
                                  # a worker's FF rate drops below
                                  # factor * fleet median (0 = off)
batch_queue_max = 4096            # pending BATCH pieces before a
                                  # submission gets BATCHREJECTED
                                  # (0 = unbounded)
batch_retry_after = 5.0           # [s] BATCHREJECTED retry hint when no
                                  # drain-rate estimate exists yet
batch_journal_fsync = True        # fsync each BATCH journal record (WAL
                                  # durability vs append latency)
journal_warn_bytes = 67108864     # [bytes] HEALTH warns when the BATCH
                                  # journal grows past this (0 = never)

# ----- fault tolerance
guard_enabled = True              # in-chunk isfinite integrity guard
guard_policy = "quarantine"       # "quarantine" | "rollback" | "halt"
snap_ring_depth = 4               # rollback horizon = depth * dt sim-sec
snap_ring_dt = 30.0               # [sim s] between ring captures (0 = off)
fault_seed = 0                    # RNG seed for the FAULT injectors

# ----- mesh-epoch recovery: losing a group of shards ends the mesh
# epoch, not the run; the survivors re-form a smaller mesh and resume
# from the last checksummed snapshot
mesh_guard_enabled = True         # MeshGuard dead-group check at every
                                  # chunk dispatch of a sharded sim
mesh_dispatch_timeout = 0.0       # [wall s] collective-wait budget;
                                  # exceeding it with stale peer
                                  # heartbeats trips mesh_lost (0 = wait
                                  # without a budget)
mesh_heartbeat_dir = ""           # shared dir for cross-process mesh
                                  # heartbeat stamps ("" = off)
mesh_heartbeat_timeout = 10.0     # [wall s] peer stamp staleness before
                                  # the peer counts as dead

# ----- durable runs (preemption-safe checkpoints)
snapshot_autosave_dt = 0.0        # [sim s] between on-disk autosnapshots
                                  # of the newest ring entry (0 = off)
snapshot_autosave_path = ""       # "" -> <log_path>/autosave.snap
preempt_snapshot_dir = ""         # "" -> log_path; preemption
                                  # checkpoints land here

# ----- observability
trace_enabled = False             # flight recorder on at startup (TRACE)
trace_ring_size = 4096            # bounded event ring per process
trace_dir = ""                    # TRACE DUMP target dir ("" -> log_path)
trace_autodump = True             # dump the ring on guard trips
metrics_export_path = ""          # Prometheus text dump file ("" = off)
metrics_export_dt = 10.0          # [wall s] min interval between dumps
scanstats = False                 # in-chunk ScanStats (SCANSTATS)
inscan_refresh = False            # in-chunk sparse sort refresh
                                  # (SORTREFRESH)
fingerprint = False               # in-chunk state fingerprint
                                  # (FINGERPRINT)

# ----- device observability (obs/devprof.py; PROFILE)
devprof_compile_telemetry = True  # capture/build duration histograms and
                                  # the dispatch cache hit/miss counters
                                  # against the chunk ladder (host-side
                                  # bookkeeping only)
devprof_mem_dt = 0.0              # [wall s] least interval between
                                  # live/peak byte samples at chunk edges
                                  # (0 = off)
devprof_donation_check = False    # after a donating dispatch, count the
                                  # input tensors the chunk did not take
                                  # over (debug only)

# ----- differentiable simulation (diff/; the OPT and GRAD commands):
# the optimizer's defaults, which the command's arguments override
opt_tend = 600.0                  # [sim s] optimization rollout horizon
opt_simdt = 1.0                   # [s] smooth-rollout step (the hard
                                  # verification runs at opt_verify_dt)
opt_chunk = 50                    # steps per checkpointed chunk
opt_iters = 40                    # Adam iterations
opt_lr = 0.15                     # Adam learning rate (normalized units)
opt_temp0 = 0.3                   # soft-LoS temperature: anneal start
opt_temp1 = 0.05                  # ... and end (fractions of rpz/hpz)
opt_restarts = 1                  # multi-start particles on the world
                                  # axis (the best one wins)
opt_los_margin = 1.2              # soft-zone inflation over the hard rpz
opt_verify_dt = 0.05              # [s] hard-metric verification step

# ----- multi-world serving (simulation/worlds.py)
world_pack = False                # pack compatible BATCH pieces into
                                  # world-batches: one worker steps W
                                  # scenarios per device dispatch
                                  # (WORLDS stack command at runtime)
world_batch_max = 8               # max pieces per world-batch dispatch

# ----- self-healing serving (network/mitigate.py; the MITIGATE
# command): every action passes a per-action token bucket, a
# per-target exponential backoff and a global budget; off, the engine
# is inert
mitigate_enabled = False          # closed-loop mitigation on the server
mitigate_budget = 64              # lifetime cap on degrading actions
                                  # (0 = unbounded); restores are free
mitigate_rate = 4                 # token-bucket capacity per action ...
mitigate_rate_window = 60.0       # ... refilled over this window [s]
mitigate_backoff_base = 5.0       # [s] first per-(action,target) delay
mitigate_backoff_cap = 300.0      # [s] exponential-backoff ceiling
mitigate_shed_hi = 0.8            # shed load (tighten batch_queue_max)
                                  # past this fraction of the limit ...
mitigate_shed_lo = 0.3            # ... restore below this fraction
mitigate_shed_factor = 0.5        # shed limit = factor x the configured
mitigate_mem_budget = 0           # [bytes] fleet live-bytes budget
                                  # (0 = off)
mitigate_mem_hi = 0.9             # re-pack (shrink world_batch_max)
                                  # past this fraction of the budget ...
mitigate_mem_lo = 0.6             # ... restore below this fraction
mitigate_repack_factor = 0.5      # re-pack width = factor x configured

# ----- silent-data-corruption defense (the server compares the
# fingerprints of redundant executions; the SDC command)
sdc_enabled = False               # server-side fingerprint comparison
sdc_audit_rate = 0.0              # fraction of FF pieces shadow re-run

# ----- broker HA (network/ha.py): a warm standby tails the journal and
# takes the lease when the leader's goes stale
ha_standby = False                # start a server as a warm standby
ha_lease_ttl = 10.0               # [wall s] leader silence before the
                                  # standby may take the lease
ha_poll_dt = 1.0                  # [wall s] lease renewal (leader) /
                                  # lease+journal polling (standby)
ha_fence_strict = True            # replay drops a deposed leader's
                                  # stale-epoch completions from the
                                  # queue math

_overrides = {}                   # file values for late-registered keys


def init(cfgfile: str = "") -> bool:
    """Load ``key = value`` lines from cfgfile into this module."""
    if not cfgfile or not os.path.isfile(cfgfile):
        return False
    mod = sys.modules[__name__]
    mod.config_file = os.path.abspath(cfgfile)
    with open(cfgfile) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, raw = line.partition("=")
            key = key.strip()
            try:
                val = ast.literal_eval(raw.strip())
            except (ValueError, SyntaxError):
                val = raw.strip()
            setattr(mod, key, val)
            _overrides[key] = val
    return True


def set_variable_defaults(**kwargs):
    """Per-module defaults registered at import time: each is set only
    if neither a default nor a config override exists yet."""
    mod = sys.modules[__name__]
    for key, value in kwargs.items():
        if key in _overrides:
            setattr(mod, key, _overrides[key])
        elif not hasattr(mod, key):
            setattr(mod, key, value)
