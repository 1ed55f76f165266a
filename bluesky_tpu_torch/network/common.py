"""Shared network helpers (port of ``bluesky_tpu/network/common.py``).

Endpoint ids are 5 random bytes with a leading zero byte so they can never
collide with single-character control tokens like ``b'*'``.
"""
import os
import socket

# Client event/stream ports, worker event/stream ports, UDP discovery
# port (the JAX package's defaults).
DEFAULT_PORTS = dict(event=9000, stream=9001,
                     wevent=10000, wstream=10001, discovery=11000)


def make_id() -> bytes:
    """A 5-byte endpoint id: zero byte + 4 random bytes."""
    return b"\x00" + os.urandom(4)


def get_ownip() -> str:
    """Best-effort non-loopback IPv4 of this host (a UDP socket's
    ``connect`` picks the route and sends nothing)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
