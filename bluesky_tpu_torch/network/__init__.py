"""Process fabric: ZMQ broker + sim nodes + clients (port of
``bluesky_tpu/network``; parity: bluesky/network/).

Topology, as in the JAX package: a server broker (ROUTER:event_port /
XPUB:stream_port for clients; ROUTER:wevent_port / XSUB:wstream_port for
workers) between clients (DEALER+SUB) and sim workers (DEALER+PUB).
``server`` is the broker and worker manager (it spawns ``python -m
bluesky_tpu_torch --sim`` workers), with its BATCH write-ahead
``journal``, broker high availability (``ha``) and the mitigation
engine (``mitigate``); ``client`` is the client endpoint; ``node`` and
``node_mt`` are the networked worker endpoints, ``detached`` the same
interface with no networking; ``discovery``, ``tcpserver`` (the raw-TCP
stack bridge) and the wire codec ``npcodec``, which is byte for byte
the JAX package's, so either package's server, client and workers talk
to the other's.

Events are source-routed multipart messages ``[*route, name, payload]``;
streams are PUB frames ``[name + node_id, payload]``.

Only ``server``, ``client``, ``node``, ``node_mt``, ``discovery`` and
``npcodec`` need pyzmq or msgpack; importing this package, ``common``,
``detached``, ``journal``, ``ha``, ``mitigate`` or ``tcpserver`` needs
neither, so a detached worker runs on a machine without them.
``packb`` and ``unpackb`` are loaded from ``npcodec`` on first access.
"""
from .common import DEFAULT_PORTS, get_ownip, make_id


def __getattr__(name):
    # the JAX package exports the codec here; importing it eagerly would
    # load msgpack for a detached worker
    if name in ("packb", "unpackb"):
        from . import npcodec
        return getattr(npcodec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
