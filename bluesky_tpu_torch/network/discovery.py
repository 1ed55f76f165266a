"""LAN server discovery via UDP broadcast (port of
``bluesky_tpu/network/discovery.py``; parity: network/discovery.py:14-73).

A client broadcasts a request datagram on the discovery port; every server
replies with its event/stream ports.  Datagrams are msgpack maps with a
magic tag so stray packets on the port are ignored.
"""
import socket
from dataclasses import dataclass

from .common import DEFAULT_PORTS, get_ownip
from .npcodec import packb, unpackb

_MAGIC = "bstpu-disc-1"


@dataclass
class Reply:
    ip: str
    event_port: int
    stream_port: int
    # broker HA (network/ha.py): servers advertise their lease epoch
    # and role so clients/workers can arbitrate between a deposed
    # leader's stale reply and the real one (highest epoch wins) and
    # skip warm standbys that are not serving yet.  Non-HA servers
    # advertise the defaults, so pre-HA wire peers keep working.
    epoch: int = 0
    role: str = "leader"
    # worker-side ports (HA replies only; 0 = not advertised): a
    # failed-over WORKER must re-REGISTER on the new leader's worker
    # ROUTER, not the client one — event/stream above are client-facing
    wevent: int = 0
    wstream: int = 0


class Discovery:
    def __init__(self, own_id: bytes, is_client: bool = True,
                 port: int = DEFAULT_PORTS["discovery"]):
        self.own_id = own_id
        self.is_client = is_client
        self.port = port
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        self.sock.bind(("", port))
        self.sock.settimeout(0.2)

    @property
    def handle(self):
        return self.sock

    def close(self):
        self.sock.close()

    def send_request(self):
        msg = packb({"magic": _MAGIC, "kind": "req", "id": self.own_id})
        self.sock.sendto(msg, ("<broadcast>", self.port))

    def send_reply(self, event_port: int, stream_port: int,
                   epoch: int = None, role: str = None,
                   wevent: int = None, wstream: int = None):
        msg = {"magic": _MAGIC, "kind": "rep", "id": self.own_id,
               "ip": get_ownip(), "event": event_port,
               "stream": stream_port}
        if epoch is not None:      # broker HA: advertise lease epoch
            msg["epoch"] = int(epoch)
        if role is not None:       # ... and role (leader/standby)
            msg["role"] = str(role)
        if wevent is not None:     # ... and the worker-facing ports
            msg["wevent"] = int(wevent)
        if wstream is not None:
            msg["wstream"] = int(wstream)
        self.sock.sendto(packb(msg), ("<broadcast>", self.port))

    def recv_reqreply(self):
        """Receive one datagram; returns ('req', None) | ('rep', Reply) |
        (None, None) on timeout/foreign traffic/own echo."""
        try:
            raw, addr = self.sock.recvfrom(4096)
        except socket.timeout:
            return None, None
        try:
            msg = unpackb(raw)
        except Exception:
            return None, None
        if not isinstance(msg, dict) or msg.get("magic") != _MAGIC:
            return None, None
        if msg.get("id") == self.own_id:
            return None, None
        if msg.get("kind") == "req":
            return "req", None
        if msg.get("kind") == "rep":
            return "rep", Reply(msg.get("ip", addr[0]), msg["event"],
                                msg["stream"],
                                int(msg.get("epoch", 0) or 0),
                                str(msg.get("role", "leader")),
                                int(msg.get("wevent", 0) or 0),
                                int(msg.get("wstream", 0) or 0))
        return None, None
