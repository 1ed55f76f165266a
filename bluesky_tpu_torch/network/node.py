"""Sim-side network endpoint (port of ``bluesky_tpu/network/node.py``;
parity: bluesky/network/node.py:13-96).

A Node owns a DEALER event socket and a PUB stream socket connected to the
Server's worker-facing ports.  Wire format for events is source-routed
multipart: ``[*route, name, payload]`` where route frames are 5-byte ids
(leading zero byte, common.make_id) or ``b'*'``; the first frame that is
neither is the event name.  Replies go back along the accumulated return
route (see server.py for the rotation rule).  Streams are PUB frames
``[name + node_id, payload]`` so SUB prefix-matching selects by stream name
(and optionally by node).
"""
import os
import threading
import time

import zmq

from ..utils.timer import Timer
from .common import DEFAULT_PORTS, make_id
from .npcodec import packb, unpackb


class EventLoopWatchdog(threading.Thread):
    """Detects a stalled worker event loop (GC pause, NFS hang, runaway
    host callback, FAULT STALL): the run loop ``beat()``s every
    iteration; if no beat lands for ``warn_after`` seconds the watchdog
    prints a warning and records the stall, and — when ``kill_after`` is
    set — exits the process with code 70 after that long, so the server
    reaps the silent worker, requeues its BATCH piece and respawns.

    ``kill_after`` defaults OFF: a first kernel build, the graph
    captures of a new shape or a long OPT piece can legitimately block
    the loop for minutes, and the
    server's busy-worker PING budget (10x hb_timeout, server.py) already
    covers pong-silence — the kill switch is for deployments that prefer
    fail-fast workers (settings.node_watchdog_kill).
    """

    def __init__(self, warn_after=30.0, kill_after=0.0, name=""):
        super().__init__(daemon=True)
        self.warn_after = float(warn_after)
        self.kill_after = float(kill_after)
        self.tag = name
        self.stalls = []             # [(stamp, silence_s)] observed stalls
        self._beat = time.monotonic()
        self._stop = threading.Event()
        self._warned = False

    def beat(self):
        self._beat = time.monotonic()
        self._warned = False

    def stop(self):
        self._stop.set()

    def run(self):
        ref = self.warn_after if self.warn_after > 0 else self.kill_after
        interval = max(0.1, min(1.0, ref / 4.0))
        while not self._stop.wait(interval):
            silence = time.monotonic() - self._beat
            if self.kill_after > 0 and silence > self.kill_after:
                print(f"watchdog{self.tag}: event loop silent "
                      f"{silence:.1f} s > kill_after="
                      f"{self.kill_after:.1f} s — exiting 70 so the "
                      "server respawns this worker", flush=True)
                os._exit(70)
            if self.warn_after > 0 and silence > self.warn_after \
                    and not self._warned:
                self._warned = True
                self.stalls.append((time.monotonic(), silence))
                print(f"watchdog{self.tag}: event loop stalled "
                      f"{silence:.1f} s (> {self.warn_after:.1f} s)",
                      flush=True)


def split_envelope(frames):
    """Split multipart frames into (route, name, payload)."""
    for i, frame in enumerate(frames):
        if not (frame == b"*" or (frame and frame[0:1] == b"\x00")):
            return frames[:i], frame, frames[i + 1] if i + 1 < len(frames) \
                else b""
    raise ValueError("malformed envelope: no name frame")


class Node:
    """Worker endpoint; subclass and override event()/step()."""

    def __init__(self, event_port: int = DEFAULT_PORTS["wevent"],
                 stream_port: int = DEFAULT_PORTS["wstream"],
                 host: str = "127.0.0.1", node_id: bytes = None,
                 watchdog_warn: float = None, watchdog_kill: float = None):
        # node_id may be assigned by the spawning server (so it can map
        # its child process to the registered worker for crash
        # detection); self-started nodes generate their own.
        self.node_id = node_id or make_id()
        self.host_id = b""        # filled by REGISTER reply
        self.running = False
        # broker HA (network/ha.py): learned from an HA server's
        # REGISTER ack — a lease epoch in the ack is what ARMS the
        # failover detector, so against a non-HA server every check
        # below is inert
        self.server_pid = None           # broker pid (FAULT KILLSERVER)
        self.server_epoch = None         # lease epoch, None = HA off
        self.server_lease_ttl = 0.0
        self.server_disc_port = None     # where to re-run discovery
        self._srv_last = time.monotonic()   # last traffic from server
        self._ha_next_probe = 0.0        # failover probe rate limit
        from .. import settings
        self._wd_warn = watchdog_warn if watchdog_warn is not None \
            else getattr(settings, "node_watchdog_warn", 30.0)
        self._wd_kill = watchdog_kill if watchdog_kill is not None \
            else getattr(settings, "node_watchdog_kill", 0.0)
        self.watchdog = None      # started by run()
        ctx = zmq.Context.instance()
        self.event_io = ctx.socket(zmq.DEALER)
        self.event_io.setsockopt(zmq.IDENTITY, self.node_id)
        # short linger so the final STATECHANGE(-1) flushes before close()
        self.event_io.setsockopt(zmq.LINGER, 500)
        self.stream_out = ctx.socket(zmq.PUB)
        self.stream_out.setsockopt(zmq.LINGER, 0)
        # bounded send buffer: a stalled broker/subscriber costs this
        # worker dropped stream frames (PUB drops at HWM), never a
        # blocked step loop (docs/FAULT_TOLERANCE.md row #11)
        self.stream_out.setsockopt(
            zmq.SNDHWM, int(getattr(settings, "stream_sndhwm", 1000)))
        self._endpoints = (f"tcp://{host}:{event_port}",
                           f"tcp://{host}:{stream_port}")

    # ------------------------------------------------------------ lifecycle
    def connect(self):
        self.event_io.connect(self._endpoints[0])
        self.stream_out.connect(self._endpoints[1])
        self.send_event(b"REGISTER", self.register_payload())

    def quit(self):
        self.running = False

    def close(self):
        self.event_io.close()
        self.stream_out.close()

    # ------------------------------------------------------------------ I/O
    def send_event(self, name: bytes, data=None, route=None):
        frames = list(route or []) + [name, packb(data)]
        self.event_io.send_multipart(frames)

    def send_stream(self, name: bytes, data):
        self.stream_out.send_multipart([name + self.node_id, packb(data)])

    # ------------------------------------------------------------- signals
    def _install_signal_handlers(self):
        """SIGTERM/SIGINT are treated as a preemption notice (cluster
        scheduler reclaiming the node, operator Ctrl-C): route them to
        ``on_preempt_signal`` so subclasses can drain the in-flight
        chunk and checkpoint instead of dying mid-scan.  Main-thread
        only (signal-module restriction); embedded/test nodes running
        in a worker thread use ``sim.request_preempt()`` directly —
        both paths converge on the same drain code."""
        import signal as _signal
        if threading.current_thread() is not threading.main_thread():
            return
        self._old_sig = {}
        for s in (_signal.SIGTERM, _signal.SIGINT):
            try:
                self._old_sig[s] = _signal.signal(
                    s, lambda signum, frame: self.on_preempt_signal(signum))
            except (ValueError, OSError):
                pass

    def _restore_signal_handlers(self):
        import signal as _signal
        for s, h in getattr(self, "_old_sig", {}).items():
            try:
                _signal.signal(s, h)
            except (ValueError, OSError, TypeError):
                pass

    def on_preempt_signal(self, signum):
        """Default preemption response: leave the loop (the teardown
        still sends STATECHANGE -1).  SimNode overrides this to drain
        the chunk and write a final checkpoint first."""
        self.quit()

    # ----------------------------------------------------------- watchdog
    def _watchdog_start(self):
        # either knob arms the thread: warn=0 + kill>0 is the
        # "fail-fast quietly" deployment and must still exit on a stall
        if (self._wd_warn > 0 or self._wd_kill > 0) \
                and self.watchdog is None:
            self.watchdog = EventLoopWatchdog(
                self._wd_warn, self._wd_kill,
                name=f"[{self.node_id.hex()[:8]}]")
            self.watchdog.start()

    def _watchdog_beat(self):
        if self.watchdog is not None:
            self.watchdog.beat()

    def _watchdog_stop(self):
        if self.watchdog is not None:
            self.watchdog.stop()

    # ------------------------------------------------------------ overrides
    def register_payload(self):
        """REGISTER payload.  The base node sends none; SimNode reports
        its in-flight BATCH piece so a re-REGISTER after broker
        failover lets the new leader ADOPT the running piece instead of
        requeueing it (server._ha_adopt)."""
        return None

    def heartbeat_payload(self, stamp):
        """PONG payload for a server PING.  The base node just echoes
        the stamp; SimNode returns a progress dict (simt, chunks done,
        state) so the server's straggler detector can distinguish a
        worker that is advancing slowly from one whose progress has
        stalled outright — and both from one that is silent (a first
        kernel build blocks this loop entirely, so NO heartbeat
        arrives and the busy-PING budget applies instead)."""
        return stamp

    def event(self, name: bytes, data, sender_route):
        """Handle one event; override in subclasses."""

    def step(self):
        """One host-loop iteration of work; override in subclasses."""

    # ------------------------------------------------------------ main loop
    def process_events(self, timeout_ms: int = 0) -> int:
        """Drain pending events; returns number handled."""
        n = 0
        while True:
            if not self.event_io.poll(timeout_ms if n == 0 else 0):
                return n
            route, name, payload = split_envelope(
                self.event_io.recv_multipart())
            n += 1
            self._srv_last = time.monotonic()  # any traffic counts
            data = unpackb(payload) if payload else None
            if name == b"REGISTER":
                # handshake ack: payload carries the server id, the
                # broker pid, and — from an HA server — the lease terms
                # that arm the failover detector
                self.host_id = data["host_id"]
                self.server_pid = data.get("pid", self.server_pid)
                if "epoch" in data:
                    self.server_epoch = int(data["epoch"])
                    self.server_lease_ttl = float(
                        data.get("lease_ttl", 0.0) or 0.0)
                    self.server_disc_port = data.get(
                        "discovery", self.server_disc_port)
            elif name == b"PING":
                # server liveness probe: echo the stamp back (the reply
                # is protocol-level so every Node flavor is covered).
                # Subclasses piggyback progress on the reply so the
                # server can tell a stalled worker from a busy one.
                self.send_event(b"PONG", self.heartbeat_payload(data))
            elif name == b"QUIT":
                self.quit()
            else:
                self.event(name, data, route)

    # ---------------------------------------------- broker-HA failover
    def _check_failover(self):
        """Broker-HA failover detector (network/ha.py): an HA server's
        REGISTER ack carried a lease epoch — once the event socket has
        been silent past 1.5x that lease ttl, re-run discovery and move
        to whichever server replies as LEADER with a strictly higher
        epoch (the promoted standby; a deposed leader's stale reply
        loses the arbitration).  Against a non-HA server no epoch was
        ever learned and this returns immediately."""
        if self.server_epoch is None or self.server_disc_port is None:
            return
        now = time.monotonic()
        ttl = self.server_lease_ttl or 10.0
        if now - self._srv_last <= 1.5 * ttl \
                or now < self._ha_next_probe:
            return
        self._ha_next_probe = now + max(0.5, ttl / 4.0)
        from .discovery import Discovery
        best = None
        try:
            disc = Discovery(self.node_id, is_client=True,
                             port=self.server_disc_port)
        except OSError:
            return
        try:
            disc.send_request()
            t_end = time.monotonic() + 0.5
            while time.monotonic() < t_end:
                kind, reply = disc.recv_reqreply()
                if kind != "rep" or reply.role != "leader":
                    continue
                if reply.epoch > self.server_epoch \
                        and (best is None or reply.epoch > best.epoch):
                    best = reply
        finally:
            disc.close()
        if best is None:
            return
        print(f"node {self.node_id.hex()[:8]}: server silent "
              f"{now - self._srv_last:.1f}s — failing over to "
              f"{best.ip}:{best.wevent or best.event_port} "
              f"(epoch {best.epoch})")
        self.server_epoch = best.epoch
        # a Node is a WORKER: reconnect to the new leader's worker-side
        # ROUTER pair, advertised separately in HA replies (the plain
        # event/stream ports are client-facing — a REGISTER there would
        # enrol us as a client and the in-flight report would be lost)
        self._reconnect(best.ip, best.wevent or best.event_port,
                        best.wstream or best.stream_port)

    def _reconnect(self, host, event_port, stream_port):
        """Move the DEALER/PUB pair to a new server.  The DEALER keeps
        its identity, so the re-REGISTER is idempotent server-side;
        frames queued to the dead endpoint are dropped with it — a lost
        completion was never journaled, so the piece stays owed and
        exactly-once holds."""
        old = self._endpoints
        self._endpoints = (f"tcp://{host}:{event_port}",
                           f"tcp://{host}:{stream_port}")
        for sock, ep in ((self.event_io, old[0]),
                         (self.stream_out, old[1])):
            try:
                sock.disconnect(ep)
            except zmq.ZMQError:
                pass
        self.event_io.connect(self._endpoints[0])
        self.stream_out.connect(self._endpoints[1])
        self.send_event(b"REGISTER", self.register_payload())
        self._srv_last = time.monotonic()

    def run(self):
        """Blocking loop: events -> step -> wall-clock timers (node.py:55-80).

        The loop beats the event-loop watchdog every iteration; a stall
        anywhere in events/step (FAULT STALL, a wedged host callback)
        is detected and reported — and, when node_watchdog_kill is set,
        turned into a clean exit(70) the server recovers from.
        """
        self.running = True
        self.connect()
        self._install_signal_handlers()
        self._watchdog_start()
        try:
            while self.running:
                self._watchdog_beat()
                self.process_events(timeout_ms=1)
                self._check_failover()
                self.step()
                Timer.update_timers()
        finally:
            # the watchdog must die with the loop even on an exception:
            # with kill_after armed, an orphaned watchdog would
            # os._exit(70) the process mid-traceback (or kill an
            # embedding host that had caught and recovered)
            self._watchdog_stop()
            self._restore_signal_handlers()
        # tell the server we are gone, then tear down
        self.send_event(b"STATECHANGE", -1)
        self.close()
