"""The settings the port reads: a copy of the ``bluesky_tpu.settings``
values its modules use, with the JAX defaults (the port imports nothing
from the JAX package).

Every path is relative to the working directory: the port reads and
writes nothing outside its checkout.  Without a ``data/performance``
directory ``Traffic`` uses the built-in coefficient tables; without
``data/navdata`` the navigation database is the built-in world set.
"""
import os

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
log_path = "output"
scenario_path = "scenario"
ref_scenario_path = ""            # a second scenario library, searched
                                  # after scenario_path ("" = none)

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
