"""The worker side of the process fabric (port of ``bluesky_tpu/network``).

Topology, as in the JAX package: a server broker (ROUTER:event_port /
XPUB:stream_port for clients; ROUTER:wevent_port / XSUB:wstream_port for
workers) between clients (DEALER+SUB) and sim workers (DEALER+PUB).  The
port has the worker half: ``node`` and ``node_mt`` (the networked worker
endpoints), ``detached`` (the same interface with no networking),
``discovery``, ``tcpserver`` (the raw-TCP stack bridge), and the wire
codec ``npcodec``, which is byte for byte the JAX package's, so a JAX
server and client read what a torch worker sends.  The server, journal,
HA and mitigation modules stay in the JAX package (ROADMAP A6c).

Events are source-routed multipart messages ``[*route, name, payload]``;
streams are PUB frames ``[name + node_id, payload]``.

Only ``node``, ``node_mt``, ``discovery`` and ``npcodec`` need pyzmq or
msgpack; importing this package, ``common``, ``detached`` or
``tcpserver`` needs neither, so a detached worker runs on a machine
without them.
"""
from .common import DEFAULT_PORTS, get_ownip, make_id
