"""Multi-world execution: W independent scenario worlds stepped as one
stacked dispatch per chunk.

Port of ``bluesky_tpu/simulation/worlds.py``.  Many small scenarios
(per-user sandboxes, Monte-Carlo ensembles, what-if sweeps) leave the
card idle when each runs alone, so a batch of them runs through this
module: W full ``Simulation`` instances own their world's host state
(stack, routes, conditionals, loggers, each with its own tagged
``LogRegistry`` so file output demuxes per world), while the device
stepping is batched.  Each iteration plans every world's next chunk
(``Simulation._plan_chunk``), groups the worlds whose chunk program is
the same (same ``SimConfig``, same guard setting, same state layout),
stacks their states along a leading world axis and dispatches
``core.step.run_steps_worlds_edge`` once for the whole group: one
launch of each CD kernel per ASAS interval for all of its worlds.  The
stacked telemetry and packs come back with a leading [W] and are sliced
back to each world's ``_apply_chunk_result``: guard response,
conditionals, trails, loggers and snapshot captures stay per world.

Worlds at different sim times batch together (each carries its own
clock); worlds whose chunk plans differ step the group at the smallest
planned chunk (a trigger is a stop-at-or-before bound and the ladder's
minimum is a ladder value, so no new graphs are captured for it).  A
group of one steps through its sim's own synchronous chunk.

A world is complete when its sim leaves OP (scenario HOLD or END); the
``on_world_done`` callback reports it.  A guard trip under policy
``halt`` marks the world failed; ``quarantine`` and ``rollback`` worlds
recover on their own and complete normally.  On preemption
``handle_preempt`` checkpoints every active world to its own file,
tagged with the world.  The port has no shard mode yet (ROADMAP A9), so
no world is refused as sharded.
"""
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .sim import Simulation, HOLD, OP, END


class WorldBatch:
    """W scenario worlds advancing through joint stacked dispatches."""

    def __init__(self, pieces: List[Tuple[list, list]], simkw=None,
                 on_world_done: Optional[Callable] = None,
                 on_echo: Optional[Callable] = None,
                 host_tag: str = ""):
        from ..utils.datalog import LogRegistry
        simkw = dict(simkw or {})
        self.on_world_done = on_world_done
        self.on_echo = on_echo
        self.status: List[Optional[str]] = [None] * len(pieces)
        self.t0 = time.monotonic()
        self.stats = {"joint_dispatches": 0, "solo_dispatches": 0,
                      "worlds_stepped": 0, "max_group": 0,
                      "solo_sharded": 0}
        self._solo_echoed = set()
        self.sims: List[Simulation] = []
        for i, (scentime, scencmd) in enumerate(pieces):
            tag = f"w{i:02d}"
            sim = Simulation(datalog_registry=LogRegistry(tag=tag),
                             world_tag=tag, **simkw)
            sim.host_tag = str(host_tag)
            # joint dispatch is synchronous by construction: every edge
            # retires before the next stacked chunk is planned
            sim.pipeline_enabled = False
            sim.stack.set_scendata(list(scentime), list(scencmd))
            sim.op()
            self.sims.append(sim)

    # ------------------------------------------------------------- status
    @property
    def nworlds(self) -> int:
        return len(self.sims)

    @property
    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.status) if s is None]

    @property
    def done(self) -> bool:
        return not self.active

    def progress(self) -> dict:
        """Aggregate progress for a worker heartbeat: the slowest active
        world's clock and the summed chunk count."""
        act = [self.sims[i] for i in self.active]
        return {
            "simt": min((s.simt_planned for s in act), default=0.0),
            "chunks": sum(s._step_count for s in self.sims),
            "state": OP if act else HOLD,
            "ntraf": sum(s.traf.ntraf for s in self.sims),
            "ff": any(s.ffmode for s in act),
            "worlds": self.nworlds,
            "worlds_done": self.nworlds - len(act),
        }

    def obs_delta(self) -> dict:
        """Summed metric increments of every world sim since the last
        call (counters and histograms add exactly; gauges last-world)."""
        from ..obs.metrics import Registry
        agg = Registry()
        for sim in self.sims:
            agg.merge(sim.obs.delta())
        return agg.delta()

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """One joint host iteration: plan every active world, dispatch
        compatible plans as stacked world-batches, apply the per-world
        edges.  Returns False once every world completed."""
        from ..core.graph import signature
        groups = {}
        for i in self.active:
            sim = self.sims[i]
            if sim.state_flag == END:
                self._finish(i)
                continue
            plan = sim._plan_chunk(None)
            self._drain_echo(i)
            if plan is None:
                # no device chunk this iteration; leaving OP completes
                # the piece
                if sim.state_flag != OP:
                    self._finish(i)
                continue
            if sim.shard_mode != "off" or sim.cfg.cd_mesh is not None:
                # the world axis composes with single-device configs
                # only: a sharded world steps on its own, loudly
                if i not in self._solo_echoed:
                    self._solo_echoed.add(i)
                    self.stats["solo_sharded"] += 1
                    self._echo(i, f"WORLDS: world {i} runs shard_mode="
                                  f"{sim.shard_mode} — stepping "
                               "unbatched (world-batching composes "
                               "with sharding later, not now)")
                key = ("solo", i)
            else:
                key = (sim.cfg, sim.guard.enabled,
                       signature(sim.traf.state))
            groups.setdefault(key, []).append((i, sim) + plan)

        for key, members in groups.items():
            if len(members) == 1:
                i, sim, chunk, simt = members[0]
                self.stats["solo_dispatches"] += 1
                self.stats["worlds_stepped"] += 1
                sim._step_sync(chunk, sim.simt)
                sim._after_chunk()
                self._drain_echo(i)
                self._maybe_finish(i)
                continue
            cfg, checked, _ = key
            self._dispatch_group(cfg, checked, members)
        return not self.done

    def _dispatch_group(self, cfg, checked: bool, members):
        """One stacked chunk for ``members`` (``(i, sim, chunk, simt)``
        of the same configuration), demuxed to each world's edge."""
        from ..core import graph
        from ..core.step import (inscan_refresh_active,
                                 run_steps_worlds_edge, stack_worlds,
                                 world_slice)
        chunk = min(m[2] for m in members)
        states = [sim._pre_dispatch_refresh(sim.traf.state, simt)
                  for i, sim, c, simt in members]
        inscan = inscan_refresh_active(cfg)
        sort_t0 = None
        if inscan:
            # the [W] due-gate vector from each member's host chain
            sort_t0 = np.stack([sim._sort_t0_for_dispatch(st) for
                                (i, sim, c, simt), st in zip(members,
                                                             states)])
        # one dispatch, W worlds; each member keeps its own seq tag
        seqs = [sim._next_seq() for i, sim, c, simt in members]
        rec = members[0][1].recorder     # per-process singleton
        with rec.span("chunk_dispatch", cat="worlds", chunk=chunk,
                      nworlds=len(members),
                      worlds=[i for i, s, c, t in members], seqs=seqs):
            out = run_steps_worlds_edge(stack_worlds(states), cfg, chunk,
                                        checked=checked, sort_t0=sort_t0)
        wstate, telem = out[0], out[1]
        if graph.leaves(wstate)[0][1].is_cuda:
            # the stacked result lives in the chunk's graph buffers: the
            # worlds keep a copy of their own, so a world that leaves the
            # group is not overwritten by the group's next chunk, and the
            # buffers go back to the executor for that chunk
            own = graph.rebuild(wstate, iter(
                [t.clone() for _, t in graph.leaves(wstate)]))
            graph.release(wstate)
            wstate = own
        # the packs join in the runner's order: stats, refresh, fingerprint
        rest = list(out[2:])
        wstats = rest.pop(0) if cfg.scanstats else None
        wrpack = rest.pop(0) if inscan else None
        wfpack = rest.pop(0) if cfg.fingerprint else None
        self.stats["joint_dispatches"] += 1
        self.stats["worlds_stepped"] += len(members)
        self.stats["max_group"] = max(self.stats["max_group"], len(members))
        pick = lambda pack, k: None if pack is None else world_slice(pack, k)
        for k, (i, sim, c, simt) in enumerate(members):
            if c > chunk and sim.syst >= 0:
                # _plan_chunk charged the wall-clock pacing anchor for
                # the full planned chunk; the group ran the group-min
                sim.syst -= (c - chunk) * sim.cfg.simdt \
                    / max(sim.dtmult, 1e-9)
            sim.pipe_stats["sync_chunks"] += 1
            sim._apply_chunk_result(world_slice(wstate, k),
                                    world_slice(telem, k), chunk,
                                    seq=seqs[k], stats=pick(wstats, k),
                                    refresh=pick(wrpack, k),
                                    fingerprint=pick(wfpack, k))
            sim._after_chunk()
            self._drain_echo(i)
            self._maybe_finish(i)

    def run(self, max_iters: int = 10 ** 9) -> List[Optional[str]]:
        """Drive ``step`` until every world completed; returns statuses."""
        it = 0
        while it < max_iters and self.step():
            it += 1
        return list(self.status)

    # -------------------------------------------------------- completion
    def _maybe_finish(self, i: int):
        if self.status[i] is None and self.sims[i].state_flag != OP:
            self._finish(i)

    def _finish(self, i: int):
        sim = self.sims[i]
        # a trip under policy 'halt' froze the corrupt world: report it
        # failed; quarantine/rollback worlds recovered and completed
        failed = sim.guard.policy == "halt" and bool(sim.guard.trips)
        self.status[i] = "failed" if failed else "completed"
        if self.on_world_done is not None:
            info = {"simt": sim.simt_planned, "ntraf": sim.traf.ntraf,
                    "trips": len(sim.guard.trips)}
            fp = sim.fp_summary()
            if fp is not None:
                info["fp"] = fp
            self.on_world_done(i, self.status[i], info)

    # ------------------------------------------------------ preempt/echo
    def handle_preempt(self) -> dict:
        """Preemption mid-pack: checkpoint every active world to its own
        tagged file (``Simulation.handle_preempt`` names it with the
        world's tag) and report what was already done, so that only the
        unfinished pieces are run again."""
        info = {"worlds": self.nworlds,
                "done": [i for i, s in enumerate(self.status)
                         if s == "completed"],
                "checkpoints": []}
        for i in self.active:
            path, err = self.sims[i].handle_preempt()
            if path:
                info["checkpoints"].append(path)
            if err:
                info.setdefault("errors", []).append(err)
        return info

    def _echo(self, i: int, text: str):
        if self.on_echo is not None:
            self.on_echo(i, text)

    def _drain_echo(self, i: int):
        buf = getattr(self.sims[i].scr, "echobuf", None)
        if buf:
            lines, buf[:] = list(buf), []
            for line in lines:
                self._echo(i, line)
