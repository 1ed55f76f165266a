"""The networked sim worker: Simulation wrapped in a network Node
(port of ``bluesky_tpu/simulation/simnode.py``; parity:
bluesky/simulation/qtgl/simulation.py:204-287 event surface +
network/node.py loop).

Event surface (same tokens as the reference): STACKCMD, STEP, BATCH, QUIT,
GETSIMSTATE.  State changes are reported to the server via STATECHANGE so
the BATCH farm can schedule the next scenario piece on this worker when it
finishes (server.py:234-247 semantics).

OPT BATCH pieces (differentiable workloads, ``diff/``): a piece whose
scenario runs the OPT stack command blocks this loop for the
optimization's duration — the server's busy-PING budget covers it
exactly like a long first chunk — then sends its OPTRESULT upstream on
this node's event socket and HOLDs, so the piece's ``completed`` record
follows the journaled ``opt_result`` on the FIFO pair.

``DetachedSimNode`` (``network/detached.Node``) imports neither pyzmq
nor msgpack.  ``SimNode`` (``network/node.Node``, which needs both) is
built on first access to the name, so importing this module for the
detached class never loads them.

Both take the Simulation's keyword arguments; ``device`` defaults to
``settings.device`` (None: CUDA, or an error without one).
"""
from .. import settings
from ..network import detached
from ..network.journal import BatchJournal
from .sim import Simulation, HOLD, OP, END
from .screenio import ScreenIO

# content-addressed id of a BATCH piece, by which a server adopts a
# worker's running piece after a failover: the journal's, the one copy
piece_key = BatchJournal.piece_key


def _make_simnode_class(base, name):
    class _SimNode(base):
        def __init__(self, event_port=None, stream_port=None, node_id=None,
                     **simkw):
            # watchdog knobs ride to the Node base, not the Simulation
            nodekw = {k: simkw.pop(k) for k in
                      ("watchdog_warn", "watchdog_kill") if k in simkw}
            simkw.setdefault("device", settings.device)
            super().__init__(
                event_port=event_port or settings.wevent_port,
                stream_port=stream_port or settings.wstream_port,
                node_id=node_id, **nodekw)
            self.sim = Simulation(**simkw)
            self.sim.scr = ScreenIO(self.sim, self)
            self.sim.node = self
            # Packed multi-world BATCH (simulation/worlds.py): the
            # server may dispatch a world-batch of compatible pieces as
            # ONE assignment; while it runs, step() drives the runner
            # instead of the main sim.  Construction kwargs are kept so
            # every world sim shares the worker's nmax bucket.
            self.worlds = None
            self._world_simkw = dict(simkw)
            # broker HA (network/ha.py): the solo BATCH piece currently
            # running, kept so a re-REGISTER after broker failover can
            # report it and the new leader ADOPTS it in place instead
            # of requeueing.  Packs are not reported (their per-world
            # completions already journaled; the rest requeues after
            # the adoption grace).
            self._batch_piece = None
            # Subsystems constructed before the swap hold the headless
            # Screen; repoint them at the streaming ScreenIO
            self.sim.areas.scr = self.sim.scr
            # BATCH stack command: upload the multi-SCEN scenario to
            # the server for farm-out (simulation.py:195-202)
            self.sim.batch = self.batch
            self.prev_state = self.sim.state_flag

        def batch(self, fname):
            ok, msg = self.sim.stack.openfile(fname)
            if not ok:
                return False, msg
            scentime = self.sim.stack.scentime
            scencmd = self.sim.stack.scencmd
            self.sim.stack.scentime, self.sim.stack.scencmd = [], []
            self.send_event(b"BATCH", {"scentime": scentime,
                                       "scencmd": scencmd})
            return True, "BATCH uploaded to the server"

        def close(self):
            self.sim.scr.close()      # deregister stream timers
            super().close()

        # ------------------------------------------------------ preemption
        def on_preempt_signal(self, signum):
            # SIGTERM from the scheduler: don't die mid-chunk — raise
            # the flag and let step() drain + checkpoint at the edge
            self.sim.request_preempt()

        def _preempt_shutdown(self):
            """Preemption-safe exit: the current chunk has drained
            (sim.step returns at chunk edges), so write the final
            checksummed checkpoint, tell the server (PREEMPTED — the
            in-flight BATCH piece is requeued WITHOUT a circuit-breaker
            strike; STATECHANGE -1 follows from the run() teardown)
            and leave cleanly."""
            sim = self.sim
            path, err = sim.handle_preempt()
            info = {"simt": sim.simt, "ntraf": sim.traf.ntraf}
            if path:
                info["checkpoint"] = path
            if err:
                info["error"] = err
            self.send_event(b"PREEMPTED", info)
            self._batch_piece = None
            sim.stop()
            self.quit()

        # ------------------------------------------------------ multi-world
        def _start_worlds(self, worlds_payload):
            """A packed BATCH assignment: run the worlds through the
            joint-dispatch WorldBatch runner.  Per-world completion is
            reported upstream as ``BATCHWORLD`` events the server
            journals per piece (exactly-once demux); per-world echo
            output streams with a ``[wNN]`` prefix."""
            from .worlds import WorldBatch
            self.sim.reset()
            pieces = [(p["scentime"], p["scencmd"])
                      for p in worlds_payload]
            self._batch_piece = None   # packs are not adoption-reported
            self.worlds = WorldBatch(
                pieces, simkw=self._world_simkw,
                host_tag=self.node_id.hex()[:8],
                on_world_done=lambda w, status, info=None:
                    self.send_event(b"BATCHWORLD",
                                    dict({"world": w, "status": status},
                                         **(info or {}))),
                on_echo=lambda w, text:
                    self.sim.scr.echo(f"[w{w:02d}] {text}"))
            self.prev_state = OP
            self.send_event(b"STATECHANGE", OP)

        def _finish_worlds(self):
            self.worlds = None
            self.prev_state = HOLD
            self.send_event(b"STATECHANGE", HOLD)

        def _preempt_worlds(self):
            """Preemption mid-pack: checkpoint every active world (one
            tagged file each), tell the server which worlds were
            already done (only the unfinished pieces requeue) and
            leave cleanly."""
            self.sim.preempt_requested = False
            info = self.worlds.handle_preempt()
            self.send_event(b"PREEMPTED", info)
            self.worlds = None
            self.sim.stop()
            self.quit()

        # --------------------------------------------------------- heartbeat
        def register_payload(self):
            """REGISTER payload: the in-flight solo BATCH piece, keyed
            by content (network/journal.py piece_key) — what lets the
            post-failover leader adopt this worker's running piece
            instead of requeueing a second copy (server._ha_adopt)."""
            if self._batch_piece is None:
                return None
            sim = self.sim
            return {"inflight": {
                "key": piece_key(self._batch_piece),
                "simt": float(sim.simt_planned),
                "chunks": int(sim._step_count)}}

        def heartbeat_payload(self, stamp):
            """Progress piggybacked on the PONG reply: sim-time and
            chunks done let the server's straggler detector tell a
            stalled piece (fresh heartbeats, flat progress) from a
            long device chunk or a first kernel build (no heartbeats at all —
            this loop is blocked, and the busy-PING budget applies)."""
            sim = self.sim
            if self.worlds is not None:
                # packed piece: aggregate progress — the slowest active
                # world's clock advances monotonically while the pack
                # runs, which is exactly the advance signal the
                # straggler detector needs
                info = dict({"stamp": stamp}, **self.worlds.progress())
                obs = self.worlds.obs_delta()
                if obs:
                    info["obs"] = obs
                # worst-case scan summary across the pack's worlds
                # (peaks max, minima min) — host dicts only, no device
                # reads, same contract as the single-sim branch below
                scans = [s._scan_last for s in self.worlds.sims
                         if s._scan_last is not None]
                if scans:
                    from ..obs import scanstats as _ss
                    info["scan"] = _ss.merge_summaries(scans)
                return info
            # "ff" gates the server's RATE-based hedging: sim-s/wall-s
            # is only comparable across workers running full speed — a
            # wall-clock-paced piece reports ~dtmult by design, which
            # must not read as "far below the fleet median".
            # planned clock: a device read here would block the event
            # loop on the in-flight pipelined chunk, turning "busy" into
            # "silent" for the server's straggler detector
            info = {"stamp": stamp, "simt": sim.simt_planned,
                    "chunks": sim._step_count,
                    "state": sim.state_flag, "ntraf": sim.traf.ntraf,
                    "ff": bool(sim.ffmode)}
            # mesh-epoch health rides the heartbeat so HEALTH can show
            # the fleet's shard state without a round-trip per worker
            if sim.shard_mode != "off" or sim.mesh_epoch > 0:
                info["mesh"] = sim.mesh_health()
            # in-scan telemetry summary (newest drained chunk): a host
            # dict stamped at the chunk edge — reading the device here
            # would block the loop exactly like the planned-clock note
            if sim.cfg.scanstats and sim._scan_last is not None:
                info["scan"] = sim._scan_last
            # SDC fingerprint chain summary: host ints stamped at each
            # drained chunk edge — same no-device-read contract; the
            # server records it per piece for hedge/vote comparison
            fp = sim.fp_summary()
            if fp is not None:
                info["fp"] = fp
            # fleet telemetry: ship the metric increments since the
            # last heartbeat; the server merges them into its fleet
            # registry (METRICS DUMP shows the aggregate)
            obs = sim.obs.delta()
            if obs:
                info["obs"] = obs
            return info

        # ------------------------------------------------------------ events
        def event(self, name, data, sender_route):
            sim = self.sim
            if name == b"STACKCMD":
                cmd = data["cmd"] if isinstance(data, dict) else str(data)
                # Reply route = REVERSED accumulated sender tail (see
                # network/server.py routing note); comma-joined hex so
                # the stack's plain-string sender survives multi-hop.
                sender = ",".join(f.hex() for f in reversed(sender_route)) \
                    if sender_route else ""
                sim.stack.stack(cmd, sender)
            elif name == b"STEP":
                # lockstep: advance exactly dtmult seconds of sim time
                # (possibly several quantized chunks), then ack
                sim.op()
                t_target = sim.simt_planned + sim.dtmult
                while sim.state_flag == OP \
                        and sim.simt_planned < t_target - 1e-9:
                    nsteps = max(1, int(round(
                        (t_target - sim.simt_planned) / sim.simdt)))
                    sim.step(max_chunk=nsteps)
                sim.pause()
                self.send_event(b"STEP", None,
                                list(reversed(sender_route)) or None)
            elif name == b"BATCH":
                if isinstance(data, dict) and data.get("worlds"):
                    self._start_worlds(data["worlds"])
                else:
                    sim.reset()
                    self._batch_piece = (data["scentime"],
                                         data["scencmd"])
                    sim.stack.set_scendata(data["scentime"],
                                           data["scencmd"])
                    sim.op()
            elif name == b"BATCHCANCEL":
                # the server hedged this piece and the other copy won:
                # ack FIRST (the FIFO event pair is how the server
                # tells a cancel ack from a duplicate completion), then
                # abandon the piece — the reset's STATECHANGE makes
                # this worker available again
                self.send_event(b"BATCHCANCELLED", None)
                self._batch_piece = None
                if self.worlds is not None:
                    self.worlds = None
                    self.prev_state = sim.state_flag
                    self.send_event(b"STATECHANGE", HOLD)
                sim.reset()
            elif name == b"BATCHREJECTED":
                d = data or {}
                sim.scr.echo(
                    f"BATCH rejected by the server: queue "
                    f"{d.get('queue_depth', '?')}/{d.get('limit', '?')} "
                    f"full — retry in {d.get('retry_after', '?')} s")
            elif name == b"HEALTH":
                # reply to the stack HEALTH command's server query
                txt = data.get("text") if isinstance(data, dict) \
                    else str(data)
                sim.scr.echo(txt or "no health data")
            elif name == b"WORLDS":
                # reply to the stack WORLDS command's server query/set
                txt = data.get("text") if isinstance(data, dict) \
                    else str(data)
                sim.scr.echo(txt or "no worlds data")
            elif name == b"MITIGATE":
                # reply to the stack MITIGATE command's server query/set
                txt = data.get("text") if isinstance(data, dict) \
                    else str(data)
                sim.scr.echo(txt or "no mitigation data")
            elif name == b"SDC":
                # reply to the stack SDC command's server query/set
                txt = data.get("text") if isinstance(data, dict) \
                    else str(data)
                sim.scr.echo(txt or "no sdc data")
            elif name == b"HA":
                # reply to the stack HA STATUS command's server query
                txt = data.get("text") if isinstance(data, dict) \
                    else str(data)
                sim.scr.echo(txt or "no ha data")
            elif name == b"METRICS":
                # reply to METRICS DUMP's server query: broker + fleet
                # registries rendered server-side
                txt = data.get("text") if isinstance(data, dict) \
                    else str(data)
                sim.scr.echo(txt or "no metrics data")
            elif name == b"TRACE":
                # reply to TRACE DUMP's server-side ring dump
                d = data if isinstance(data, dict) else {}
                sim.scr.echo(
                    f"server trace: {d.get('path') or 'ring empty'}"
                    if d.get("enabled")
                    else "server trace: recorder disabled")
            elif name == b"GETSIMSTATE":
                self.send_event(b"SIMSTATE", {
                    "state": sim.state_flag, "simt": sim.simt_planned,
                    "simdt": sim.simdt, "ntraf": sim.traf.ntraf},
                    list(reversed(sender_route)) or None)
            elif name == b"QUIT":
                sim.stop()
                self.quit()

        # -------------------------------------------------------------- step
        def step(self):
            import time as _time
            sim = self.sim
            sim.scr.update()
            if self.worlds is not None:
                running = self.worlds.step()
                if sim.preempt_requested and self.running:
                    self._preempt_worlds()
                    return
                if not running:
                    self._finish_worlds()
                return
            alive = sim.step()
            # mesh-epoch transitions (device-group loss + recovery)
            # queued by sim._handle_mesh_lost — tell the server so it
            # journals the mesh_lost/resharded audit pair (or requeues
            # the piece PREEMPTED-style when recovery failed)
            while sim.mesh_events:
                self.send_event(b"MESHLOST", sim.mesh_events.pop(0))
            if sim.preempt_requested and self.running:
                self._preempt_shutdown()
                return
            if sim.state_flag != OP:
                _time.sleep(0.02)   # idle pacing (~50 Hz stack polling)
            if sim.state_flag != self.prev_state:
                was_op = self.prev_state == OP
                self.prev_state = sim.state_flag
                if was_op and sim.state_flag != OP:
                    self._batch_piece = None   # piece left flight
                    # completion fingerprint: SDCFP rides the FIFO
                    # event pair ahead of the STATECHANGE, so the
                    # server can journal/compare it against the piece
                    # this worker still has in flight (the OPTRESULT
                    # ordering contract)
                    fp = sim.fp_summary()
                    if fp is not None:
                        self.send_event(b"SDCFP", fp)
                self.send_event(b"STATECHANGE", sim.state_flag)
            if not alive or sim.state_flag == END:
                self.quit()

    _SimNode.__name__ = _SimNode.__qualname__ = name
    return _SimNode


DetachedSimNode = _make_simnode_class(detached.Node, "DetachedSimNode")


def __getattr__(name):
    # the networked class needs pyzmq and msgpack: build it on first use
    if name == "SimNode":
        from ..network import node as netnode
        cls = _make_simnode_class(netnode.Node, "SimNode")
        globals()["SimNode"] = cls
        return cls
    raise AttributeError(name)
