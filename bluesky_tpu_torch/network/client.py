"""GUI/script-side network endpoint (port of
``bluesky_tpu/network/client.py``; parity:
bluesky/network/client.py:16-196).

DEALER event socket + SUB stream socket.  ``connect()`` performs the
REGISTER handshake with a timeout; ``receive()`` pumps both sockets and
emits ``event_received(name, data, sender_id)`` /
``stream_received(name, data, sender_id)`` signals.  Tracks the set of sim
nodes (from NODESCHANGED) and an *active node* that untargeted events
(stack commands) are routed to.
"""
import time

import zmq

from ..utils.signalslot import Signal
from .common import DEFAULT_PORTS, make_id
from .discovery import Discovery
from .node import split_envelope
from .npcodec import packb, unpackb


class Client:
    def __init__(self):
        self.client_id = make_id()
        self.host_id = b""
        self.nodes = []            # known sim node ids
        self.act = b""             # active node id
        self.event_received = Signal("event")
        self.stream_received = Signal("stream")
        self.nodes_changed = Signal("nodes")
        self._pending = []         # node-bound events queued until a node registers
        self.last_rejection = None  # latest BATCHREJECTED payload (the
        #                             admission-control refusal carries
        #                             queue depth + a retry-after hint)
        self.last_health = None     # latest HEALTH reply payload
        self.last_metrics = None    # latest METRICS (telemetry) reply
        self.last_trace = None      # latest TRACE reply (dump path)
        self.last_ha = None         # latest HA (broker-HA) reply
        # broker HA (network/ha.py): lease terms learned from an HA
        # server's REGISTER ack — None epoch means a non-HA server and
        # failover() has nothing to arbitrate with
        self.host_pid = None
        self.host_epoch = None
        self.host_lease_ttl = 0.0
        self.host_disc_port = None
        self._endpoints = None      # (event, stream) currently connected
        self.opt_results = []       # BATCHOPT reports (OPT-piece
        #                             trajectory-optimization results:
        #                             offsets + objective trace)
        ctx = zmq.Context.instance()
        self.event_io = ctx.socket(zmq.DEALER)
        self.event_io.setsockopt(zmq.IDENTITY, self.client_id)
        self.event_io.setsockopt(zmq.LINGER, 0)
        self.stream_in = ctx.socket(zmq.SUB)
        self.stream_in.setsockopt(zmq.LINGER, 0)

    # ----------------------------------------------------------- connection
    def connect(self, host="127.0.0.1", event_port=DEFAULT_PORTS["event"],
                stream_port=DEFAULT_PORTS["stream"], timeout=5.0,
                backoff_base=None, backoff_cap=None):
        """REGISTER handshake with exponential backoff + jitter.

        A dropped or late server (not yet bound, restarting, a dropped
        REGISTER frame) is survived by re-sending REGISTER with the
        per-attempt wait growing ``backoff_base * 2^k`` up to
        ``backoff_cap``, plus 0-25% random jitter so a fleet of clients
        re-registering after a server restart does not stampede in sync.
        Total wall time stays bounded by ``timeout``; attempts are
        counted in ``self.connect_attempts``.
        """
        from .. import settings
        import random
        base = backoff_base if backoff_base is not None \
            else getattr(settings, "connect_backoff_base", 0.25)
        cap = backoff_cap if backoff_cap is not None \
            else getattr(settings, "connect_backoff_cap", 4.0)
        self._endpoints = (f"tcp://{host}:{event_port}",
                           f"tcp://{host}:{stream_port}")
        self.event_io.connect(self._endpoints[0])
        self.stream_in.connect(self._endpoints[1])
        deadline = time.perf_counter() + timeout
        delay = max(1e-3, float(base))
        self.connect_attempts = 0
        while time.perf_counter() < deadline:
            self.connect_attempts += 1
            self.send_event(b"REGISTER", target=b"")
            # wait one backoff interval (bounded by the deadline) for
            # the handshake ack before re-sending
            t_end = min(deadline,
                        time.perf_counter() + delay * (1.0
                                                       + 0.25 * random.random()))
            while time.perf_counter() < t_end:
                if self.event_io.poll(50):
                    route, name, payload = split_envelope(
                        self.event_io.recv_multipart())
                    if name == b"REGISTER":
                        data = unpackb(payload)
                        self.host_id = data["host_id"]
                        self._absorb_ha_ack(data)
                        self._set_nodes(data["nodes"])
                        return
                    self._dispatch(route, name, payload)
            delay = min(delay * 2.0, float(cap))
        raise TimeoutError(
            f"no REGISTER reply from server after "
            f"{self.connect_attempts} attempts in {timeout:.1f} s")

    def close(self):
        self.event_io.close()
        self.stream_in.close()

    def _absorb_ha_ack(self, data):
        """Fold an HA server's REGISTER-ack lease terms in (pid always
        rides the ack; epoch/ttl/discovery only from an HA server)."""
        if not isinstance(data, dict):
            return
        self.host_pid = data.get("pid", self.host_pid)
        if "epoch" in data:
            self.host_epoch = int(data["epoch"])
            self.host_lease_ttl = float(data.get("lease_ttl", 0.0)
                                        or 0.0)
            self.host_disc_port = data.get("discovery",
                                           self.host_disc_port)

    @staticmethod
    def arbitrate(replies):
        """Pick the server to talk to from a burst of discovery
        replies: standbys are skipped (not serving), the highest lease
        epoch wins (a deposed leader's stale reply advertises an older
        one), first-seen breaks ties.  Returns a discovery.Reply or
        None."""
        best = None
        for reply in replies:
            if reply is None or reply.role == "standby":
                continue
            if best is None or reply.epoch > best.epoch:
                best = reply
        return best

    @staticmethod
    def discover(timeout=3.0, settle=0.25, port=None):
        """Broadcast on the LAN and return the winning discovery.Reply.

        After the first reply lands, keep collecting for a short
        ``settle`` window so two-servers-one-leader setups (broker HA:
        a live leader plus a deposed one or a warm standby) arbitrate
        by epoch/role instead of by datagram race."""
        disc = Discovery(make_id(), is_client=True,
                         **({"port": port} if port else {}))
        replies = []
        try:
            disc.send_request()
            t_end = time.perf_counter() + timeout
            while time.perf_counter() < t_end:
                kind, reply = disc.recv_reqreply()
                if kind == "rep":
                    replies.append(reply)
                    t_end = min(t_end,
                                time.perf_counter() + max(0.0, settle))
        finally:
            disc.close()
        return Client.arbitrate(replies)

    def failover(self, timeout=3.0):
        """Broker-HA failover: re-run discovery, move the DEALER/SUB
        pair to the arbitration winner (a leader with a strictly higher
        epoch than the one we registered with) and re-REGISTER.  The
        DEALER identity is preserved, so the server sees the same
        client.  Returns True if a newer leader was adopted."""
        if self.host_epoch is None:
            return False           # non-HA server: nothing to fail to
        best = self.discover(timeout=timeout, port=self.host_disc_port)
        if best is None or best.epoch <= self.host_epoch:
            return False
        old = self._endpoints
        self._endpoints = (f"tcp://{best.ip}:{best.event_port}",
                           f"tcp://{best.ip}:{best.stream_port}")
        if old:
            for sock, ep in ((self.event_io, old[0]),
                             (self.stream_in, old[1])):
                try:
                    sock.disconnect(ep)
                except zmq.ZMQError:
                    pass
        self.event_io.connect(self._endpoints[0])
        self.stream_in.connect(self._endpoints[1])
        self.host_epoch = best.epoch
        self.send_event(b"REGISTER", target=b"")
        return True

    # ----------------------------------------------------------------- I/O
    def send_event(self, name: bytes, data=None, target=None):
        """target: None -> active node, b'' -> server, b'*' -> all nodes,
        or an explicit node id."""
        if target is None:
            if not self.nodes:
                # no sim node registered yet (worker still starting up):
                # queue instead of broadcasting into an empty worker set
                self._pending.append((name, data))
                return
            target = self.act or b"*"
        route = [target] if target else []
        self.event_io.send_multipart(route + [name, packb(data)])

    def stack(self, cmdline: str, target=None):
        self.send_event(b"STACKCMD", cmdline, target)

    def request_health(self):
        """Ask the server for its serving-fabric health snapshot; the
        reply arrives as a ``HEALTH`` event (also cached in
        ``self.last_health``)."""
        self.send_event(b"HEALTH", target=b"")

    def request_metrics(self):
        """Ask the server for its telemetry registries (broker + fleet
        aggregate); the reply arrives as a ``METRICS`` event (cached in
        ``self.last_metrics``)."""
        self.send_event(b"METRICS", target=b"")

    def subscribe(self, streamname: bytes, node_id: bytes = b""):
        self.stream_in.setsockopt(zmq.SUBSCRIBE, streamname + node_id)

    def unsubscribe(self, streamname: bytes, node_id: bytes = b""):
        self.stream_in.setsockopt(zmq.UNSUBSCRIBE, streamname + node_id)

    def actnode(self, node_id: bytes = None) -> bytes:
        if node_id is not None and node_id in self.nodes:
            self.act = node_id
        return self.act

    # ------------------------------------------------------------- receive
    def receive(self, timeout_ms: int = 0) -> int:
        """Pump both sockets; returns number of messages handled."""
        n = 0
        while self.event_io.poll(timeout_ms if n == 0 else 0):
            route, name, payload = split_envelope(
                self.event_io.recv_multipart())
            self._dispatch(route, name, payload)
            n += 1
        while self.stream_in.poll(0):
            topic, payload = self.stream_in.recv_multipart()
            name, sender = topic[:-5], topic[-5:]
            self.stream_received.emit(name, unpackb(payload), sender)
            n += 1
        return n

    def _dispatch(self, route, name, payload):
        data = unpackb(payload) if payload else None
        if name in (b"NODESCHANGED", b"REGISTER"):
            # REGISTER here is the late ack of a retried handshake
            # (backoff re-sends) or of a failover re-REGISTER: absorb
            # it as a node-table + HA-lease refresh instead of
            # surfacing a duplicate handshake event
            self.host_id = data["host_id"]
            if name == b"REGISTER":
                self._absorb_ha_ack(data)
            self._set_nodes(data["nodes"])
        else:
            if name == b"BATCHREJECTED":
                self.last_rejection = data   # retry logic reads this
            elif name == b"HEALTH":
                self.last_health = data
            elif name == b"METRICS":
                self.last_metrics = data
            elif name == b"TRACE":
                self.last_trace = data
            elif name == b"HA":
                self.last_ha = data
            elif name == b"BATCHOPT":
                self.opt_results.append(data)
            sender = route[0] if route else b""
            self.event_received.emit(name, data, sender)

    def _set_nodes(self, nodes):
        self.nodes = list(nodes)
        if (not self.act or self.act not in self.nodes) and self.nodes:
            self.act = self.nodes[0]
        self.nodes_changed.emit(self.nodes)
        if self.nodes and self._pending:
            pending, self._pending = self._pending, []
            for name, data in pending:
                self.send_event(name, data)
