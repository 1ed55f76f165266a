"""The settings the port reads: a copy of the ``bluesky_tpu.settings``
values its modules use, with the JAX defaults (the port imports nothing
from the JAX package), and JAX's two-level scheme: a config file
(``init``) plus per-module registered defaults
(``set_variable_defaults``).  The config file is a restricted ``key =
value`` file, each value read with ``ast.literal_eval``; unknown keys are
kept so that modules registering defaults later still pick them up.

One key JAX lacks: ``device``, the port's device policy at the command
line.  ``None`` (the default) is ``bluesky_tpu_torch.resolve_device``'s:
CUDA, or an error when there is none; ``device = 'cpu'`` in a config
file runs the worker on the CPU.

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

device = None                     # the worker's torch device (None:
                                  # CUDA, or an error without one)

# ----- network: a worker's server-facing event and stream ports
wevent_port = DEFAULT_PORTS["wevent"]
wstream_port = DEFAULT_PORTS["wstream"]
telnet_port = 8888                # raw-TCP stack bridge of --sim and
                                  # --detached (0 = off)
node_watchdog_warn = 30.0         # [s] event-loop silence before warning
node_watchdog_kill = 0.0          # [s] silence before exit(70); 0 = never
stream_sndhwm = 1000              # [msgs] send buffer bound of a node's
                                  # stream socket (drops, never blocks)

# ----- fault tolerance
guard_enabled = True              # in-chunk isfinite integrity guard
guard_policy = "quarantine"       # "quarantine" | "rollback" | "halt"
snap_ring_depth = 4               # rollback horizon = depth * dt sim-sec
snap_ring_dt = 30.0               # [sim s] between ring captures (0 = off)

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

# ----- serving-fabric switches a server inherits (the WORLDS, MITIGATE,
# SDC and HA commands read and set them on a detached sim)
mitigate_enabled = False          # closed-loop mitigation on the server
sdc_enabled = False               # server-side fingerprint comparison
sdc_audit_rate = 0.0              # fraction of FF pieces shadow re-run
ha_standby = False                # start a server as a warm standby
ha_lease_ttl = 10.0               # [wall s] leader silence before the
                                  # standby may take the lease

_overrides = {}                   # file values for late-registered keys


def init(cfgfile: str = "") -> bool:
    """Load ``key = value`` lines from cfgfile into this module."""
    if not cfgfile or not os.path.isfile(cfgfile):
        return False
    mod = sys.modules[__name__]
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
