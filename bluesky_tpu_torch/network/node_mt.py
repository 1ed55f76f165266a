"""Multithreaded sim node: network I/O on a dedicated thread.

Parity with the reference ``bluesky/network/node_mt.py:9-96``: the
TCP-facing sockets (DEALER events, PUB streams) live in an ``IOThread``
that shuttles frames to/from the sim thread over inproc PAIR sockets.
The sim loop therefore never blocks on the broker — a stalled or slow
server cannot stall a device step chunk, and outbound streams are
buffered by the thread while a chunk runs.

Port of ``bluesky_tpu/network/node_mt.py``.  The wire format is
identical to :class:`~bluesky_tpu_torch.network.node.Node`
(source-routed multipart events, name-prefixed PUB streams), so an
``MTNode`` is a drop-in replacement wherever a ``Node`` subclass is
used; only the socket plumbing differs.  Like the reference, this
flavor is optional — the default single-threaded node is simpler and
the chunked step's host share is small — but long host-side event
handlers (scenario loads, BATCH fan-in) benefit.
"""
import threading

import zmq

from ..utils.timer import Timer
from .common import DEFAULT_PORTS
from .node import Node, split_envelope
from .npcodec import packb, unpackb

_QUIT = b"__IOQUIT__"


class IOThread(threading.Thread):
    """The I/O loop (reference node_mt.py IOThread.run:10-42): poll the
    TCP sockets and the inproc back-ends, forwarding frames both ways
    until the quit sentinel arrives from the sim side."""

    def __init__(self, endpoints, identity, inproc_event, inproc_stream):
        super().__init__(daemon=True)
        self.endpoints = endpoints
        self.identity = identity
        self.inproc = (inproc_event, inproc_stream)

    def run(self):
        ctx = zmq.Context.instance()
        fe_event = ctx.socket(zmq.DEALER)
        fe_event.setsockopt(zmq.IDENTITY, self.identity)
        fe_event.setsockopt(zmq.LINGER, 500)
        fe_stream = ctx.socket(zmq.PUB)
        fe_stream.setsockopt(zmq.LINGER, 0)
        be_event = ctx.socket(zmq.PAIR)
        be_stream = ctx.socket(zmq.PAIR)
        fe_event.connect(self.endpoints[0])
        fe_stream.connect(self.endpoints[1])
        be_event.connect(self.inproc[0])
        be_stream.connect(self.inproc[1])

        poller = zmq.Poller()
        poller.register(fe_event, zmq.POLLIN)
        poller.register(be_event, zmq.POLLIN)
        poller.register(be_stream, zmq.POLLIN)
        try:
            while True:
                socks = dict(poller.poll(None))
                if socks.get(fe_event) == zmq.POLLIN:
                    be_event.send_multipart(fe_event.recv_multipart())
                if socks.get(be_event) == zmq.POLLIN:
                    msg = be_event.recv_multipart()
                    if msg[0] == _QUIT:
                        break
                    fe_event.send_multipart(msg)
                if socks.get(be_stream) == zmq.POLLIN:
                    fe_stream.send_multipart(be_stream.recv_multipart())
        except zmq.ZMQError:
            pass                        # context terminated
        finally:
            fe_event.close()
            fe_stream.close()
            be_event.close()
            be_stream.close()


class MTNode(Node):
    """Node whose TCP sockets live in an :class:`IOThread`."""

    def __init__(self, event_port: int = DEFAULT_PORTS["wevent"],
                 stream_port: int = DEFAULT_PORTS["wstream"],
                 host: str = "127.0.0.1", node_id: bytes = None):
        super().__init__(event_port=event_port, stream_port=stream_port,
                         host=host, node_id=node_id)
        # Replace the direct TCP sockets with inproc bridges; the thread
        # owns the network side.
        self.event_io.close()
        self.stream_out.close()
        ctx = zmq.Context.instance()
        ep_event = f"inproc://mtnode-event-{self.node_id.hex()}"
        ep_stream = f"inproc://mtnode-stream-{self.node_id.hex()}"
        self.event_io = ctx.socket(zmq.PAIR)
        self.event_io.bind(ep_event)
        self.stream_out = ctx.socket(zmq.PAIR)
        self.stream_out.bind(ep_stream)
        self.io_thread = IOThread(self._endpoints, self.node_id,
                                  ep_event, ep_stream)

    # ------------------------------------------------------------ lifecycle
    def connect(self):
        # A PAIR send with no connected peer blocks forever; if the
        # IOThread dies on startup (bad endpoint, context teardown) the
        # REGISTER send would hang the sim thread.  Bound only this send
        # — steady-state sends keep the blocking-backpressure contract
        # (the thread buffers; a stalled broker must not crash the loop).
        self.io_thread.start()
        self.event_io.setsockopt(zmq.SNDTIMEO, 2000)
        try:
            self.send_event(b"REGISTER", None)
        except zmq.Again:
            alive = self.io_thread.is_alive()
            raise RuntimeError(
                "MTNode I/O thread %s — REGISTER send timed out"
                % ("is not consuming" if alive else "died on startup"))
        finally:
            self.event_io.setsockopt(zmq.SNDTIMEO, -1)

    def close(self):
        # stop the I/O thread first, then tear down the inproc pair;
        # bound the _QUIT send the same way as REGISTER (a dead thread
        # must not hang teardown).
        self.event_io.setsockopt(zmq.SNDTIMEO, 2000)
        try:
            self.event_io.send_multipart([_QUIT])
            self.io_thread.join(timeout=2.0)
        except zmq.ZMQError:
            pass
        self.event_io.close()
        self.stream_out.close()

    # ------------------------------------------------------------------ I/O
    def send_stream(self, name: bytes, data):
        # PAIR to the thread (which PUBlishes); same frame format
        self.stream_out.send_multipart([name + self.node_id, packb(data)])

    def run(self):
        """Blocking loop, identical contract to Node.run — the poll on
        the inproc PAIR returns instantly whether or not the broker is
        reachable, which is the point of the threaded flavor."""
        self.running = True
        self.connect()
        self._watchdog_start()
        try:
            while self.running:
                self._watchdog_beat()
                self.process_events(timeout_ms=1)
                self.step()
                Timer.update_timers()
        finally:
            self._watchdog_stop()   # see Node.run: must not outlive loop
        self.send_event(b"STATECHANGE", -1)
        self.close()
