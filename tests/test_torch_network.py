"""The worker side of the port's network (``bluesky_tpu_torch.network``)
against the JAX package's, on the CPU.

* ``npcodec``: the port's frames are byte for byte JAX's, and each
  package decodes the other's, for float32/64, int32/64, bool and uint8
  arrays, 0-d and empty arrays, nested dicts and lists, bytes and str.
* ``make_id`` (on the same random bytes), ``split_envelope`` and the
  discovery datagrams equal JAX's.
* A torch ``Node`` and ``MTNode`` register with a JAX ``Server`` and
  echo a JAX ``Client``'s events, receive broadcasts and publish streams
  (the JAX ``tests/test_network.py`` pattern).
* The raw-TCP stack bridge (``network/tcpserver``) on the port's
  ``Simulation`` (the JAX ``tests/test_tcp_bridge.py`` cases).
"""
import os
import socket
import threading
import time

import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from bluesky_tpu.network import npcodec as jcodec
from bluesky_tpu.network import common as jcommon
from bluesky_tpu.network.client import Client
from bluesky_tpu.network.node import split_envelope as jsplit
from bluesky_tpu.network.server import Server
from bluesky_tpu_torch.network import common as tcommon
from bluesky_tpu_torch.network import npcodec as tcodec
from bluesky_tpu_torch.network.node import Node, split_envelope as tsplit
from bluesky_tpu_torch.network.node_mt import MTNode
from tests.test_network import free_ports, wait_for

from torch_parity import no_pacing  # (and torch at one thread)

DTYPES = ("float32", "float64", "int32", "int64", "bool", "uint8")


def _arrays(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        a = rng.random((3, 5)) > 0.5
    elif dtype.startswith("float"):
        a = rng.normal(0, 1e3, (3, 5)).astype(dtype)
    else:
        a = rng.integers(0, 200, (3, 5)).astype(dtype)
    return {"a": a, "zero_d": np.array(a.ravel()[0]),
            "empty": np.zeros((0, 4), dtype=dtype),
            "col": np.ascontiguousarray(a[:, 1])}


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_npcodec_arrays_cross_packages(dtype, direction):
    msg = _arrays(dtype, seed=DTYPES.index(dtype))
    enc, dec = (tcodec, jcodec) if direction == "port_to_jax" \
        else (jcodec, tcodec)
    raw = enc.packb(msg)
    assert raw == dec.packb(msg)            # wire-identical
    _assert_same(dec.unpackb(raw), msg)


def test_npcodec_nested_bytes_and_str():
    rng = np.random.default_rng(3)
    msg = {"text": "ECHO ok", "blob": b"\x00\x01\xff", "none": None,
           "f": 2.5, "i": -7, "t": True,
           "nested": {"ids": ["KL1", "KL2"],
                      "lat": rng.uniform(50, 55, 2).astype(np.float32),
                      "deep": [{"k": np.arange(3, dtype=np.int64)},
                               [np.float64(1.5), np.int32(4)]]},
           7: "int key"}
    for enc, dec in ((tcodec, jcodec), (jcodec, tcodec)):
        raw = enc.packb(msg)
        assert raw == dec.packb(msg)
        out = dec.unpackb(raw)
        want = dict(msg)
        # numpy scalars travel as Python numbers in both packages
        want["nested"] = dict(msg["nested"], deep=[
            msg["nested"]["deep"][0], [1.5, 4]])
        _assert_same(out, want)


def test_npcodec_refuses_a_tensor():
    import torch
    with pytest.raises(TypeError, match="cannot serialize"):
        tcodec.packb({"x": torch.zeros(2)})


def test_make_id_and_ports_match_jax(monkeypatch):
    for seed in range(5):
        rng = np.random.default_rng(seed)
        raw = rng.integers(0, 256, 4).astype(np.uint8).tobytes()
        monkeypatch.setattr(os, "urandom", lambda n, _r=raw: _r[:n])
        assert tcommon.make_id() == jcommon.make_id() == b"\x00" + raw
    assert tcommon.DEFAULT_PORTS == jcommon.DEFAULT_PORTS
    assert tcommon.get_ownip() == jcommon.get_ownip()


def test_split_envelope_matches_jax():
    rng = np.random.default_rng(11)
    cases = [[b"QUIT", b""], [b"STEP"]]
    for _ in range(30):
        route = [b"*" if rng.random() < 0.2
                 else b"\x00" + rng.integers(0, 256, 4).astype(
                     np.uint8).tobytes()
                 for _ in range(int(rng.integers(0, 4)))]
        cases.append(route + [b"ECHO", bytes(rng.integers(
            0, 256, int(rng.integers(0, 9))).astype(np.uint8))])
    for frames in cases:
        assert tsplit(frames) == jsplit(frames)
    for bad in ([b"*", b"\x00abcd"], []):
        for fn in (tsplit, jsplit):
            with pytest.raises(ValueError, match="no name frame"):
                fn(bad)


def test_discovery_datagrams_match_jax():
    from bluesky_tpu.network import discovery as jdisc
    from bluesky_tpu_torch.network import discovery as tdisc
    assert tdisc._MAGIC == jdisc._MAGIC
    # a reply the port packs is the Reply JAX reads, and back
    msg = {"magic": jdisc._MAGIC, "kind": "rep", "id": b"\x00abcd",
           "ip": "10.1.2.3", "event": 9000, "stream": 9001, "epoch": 3,
           "role": "leader", "wevent": 10000, "wstream": 10001}
    assert tcodec.packb(msg) == jcodec.packb(msg)
    assert tdisc.Reply("10.1.2.3", 9000, 9001, 3, "leader", 10000,
                       10001) == tdisc.Reply(
        **jdisc.Reply("10.1.2.3", 9000, 9001, 3, "leader", 10000,
                      10001).__dict__)


class EchoNode(Node):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.got = []

    def event(self, name, data, sender_route):
        self.got.append((name, data))
        if name == b"STACKCMD":
            self.send_event(b"ECHO", f"ok: {data}",
                            route=list(sender_route))


class EchoMTNode(MTNode):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.got = []

    def event(self, name, data, sender_route):
        self.got.append((name, data))
        if name == b"STACKCMD":
            self.send_event(b"ECHO", f"ok: {data}",
                            route=list(sender_route))


@pytest.fixture(params=["node", "node_mt"])
def fabric(request):
    """A JAX Server, a torch echo node registered with it and a JAX
    Client, for both node flavors."""
    ev, st, wev, wst = free_ports(4)
    server = Server(headless=True, spawn_workers=False,
                    ports=dict(event=ev, stream=st, wevent=wev,
                               wstream=wst))
    server.start()
    client = Client()
    node = thread = None
    try:
        time.sleep(0.2)
        cls = EchoNode if request.param == "node" else EchoMTNode
        node = cls(event_port=wev, stream_port=wst)
        thread = threading.Thread(target=node.run, daemon=True)
        thread.start()
        client.connect(event_port=ev, stream_port=st, timeout=5.0)
        assert wait_for(lambda: client.receive(10) or len(client.nodes) > 0)
        # the server names the node to the client before the node has
        # applied the REGISTER reply (an MTNode applies it on its sim
        # thread's next process_events): wait for the handshake too
        assert wait_for(lambda: node.host_id == server.server_id)
        yield server, node, client
    finally:
        if node is not None:
            node.quit()
            thread.join(timeout=5)
        server.stop()
        server.join(timeout=5)
        client.close()


def test_node_registers_and_echoes(fabric):
    server, node, client = fabric
    assert node.node_id in client.nodes
    assert node.host_id == server.server_id == client.host_id
    got = []
    client.event_received.connect(lambda n, d, s: got.append((n, d)))
    client.stack("HELLO")
    assert wait_for(lambda: (client.receive(10), got)[1], timeout=5)
    assert got[0] == (b"ECHO", "ok: HELLO")


def test_broadcast_and_stream(fabric):
    server, node, client = fabric
    client.send_event(b"CUSTOM", {"x": np.arange(3)}, target=b"*")
    assert wait_for(lambda: any(n == b"CUSTOM" for n, _ in node.got))
    data = next(d for n, d in node.got if n == b"CUSTOM")
    np.testing.assert_array_equal(data["x"], np.arange(3))
    frames = []
    client.stream_received.connect(lambda n, d, s: frames.append((n, d, s)))
    client.subscribe(b"TEST")
    time.sleep(0.3)

    def published():
        node.send_stream(b"TEST", {"v": np.float32(1.5),
                                   "a": np.ones(2, np.float32)})
        client.receive(20)
        return frames
    assert wait_for(published, timeout=5)
    name, data, sender = frames[0]
    assert name == b"TEST" and sender == node.node_id
    assert data["v"] == 1.5 and data["a"].dtype == np.float32


def test_quit_fans_out(fabric):
    server, node, client = fabric
    client.send_event(b"QUIT", target=b"*")
    assert wait_for(lambda: not node.running, timeout=5)


# ------------------------------------------------------- the TCP bridge
@pytest.fixture()
def simtcp(monkeypatch):
    import torch
    from bluesky_tpu_torch.network.tcpserver import StackTelnetServer
    from bluesky_tpu_torch.simulation.sim import Simulation
    no_pacing(monkeypatch)
    sim = Simulation(nmax=16, dtype=torch.float64, device="cpu")
    srv = StackTelnetServer(sim, port=0)
    port = srv.start()
    sim.telnet = srv
    try:
        yield sim, srv, port
    finally:
        srv.stop()
    assert not srv._accept_thread.is_alive()


def _send_and_pump(sim, sock, line, timeout=5.0):
    sock.sendall(line.encode() + b"\n")
    deadline = time.time() + timeout
    sock.settimeout(0.1)
    reply = b""
    while time.time() < deadline:
        sim.step()       # the sim loop pumps the bridge
        try:
            reply += sock.recv(65536)
            if reply.endswith(b"\n"):
                break
        except socket.timeout:
            continue
    return reply.decode(errors="ignore")


def test_cre_pos_over_tcp(simtcp):
    sim, srv, port = simtcp
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        time.sleep(0.1)
        # CRE, FF and OP echo nothing: a short wait each
        _send_and_pump(sim, sock, "CRE KL204 B744 52 4 90 FL200 250", 0.5)
        out = _send_and_pump(sim, sock, "POS KL204")
        assert "KL204" in out and "20000 ft" in out
        assert sim.traf.ntraf == 1


def test_syntax_error_reply(simtcp):
    sim, srv, port = simtcp
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        time.sleep(0.1)
        out = _send_and_pump(sim, sock, "CRE")
        assert "Usage" in out or "missing" in out
        out = _send_and_pump(sim, sock, "NOSUCHCMD FOO")
        assert "Unknown command" in out


def test_two_clients_get_their_own_replies(simtcp):
    sim, srv, port = simtcp
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s1, \
            socket.create_connection(("127.0.0.1", port), timeout=5) as s2:
        time.sleep(0.1)
        out1 = _send_and_pump(sim, s1, "ECHO client one")
        out2 = _send_and_pump(sim, s2, "ECHO client two")
        assert "client one" in out1 and "client two" not in out1
        assert "client two" in out2
        assert srv.numConnections() == 2


def test_drives_running_simulation(simtcp):
    sim, srv, port = simtcp
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        time.sleep(0.1)
        _send_and_pump(sim, sock, "CRE KL204 B744 52 4 90 FL200 250", 0.5)
        _send_and_pump(sim, sock, "FF", 0.5)
        _send_and_pump(sim, sock, "OP", 0.5)
        sim.run(until_simt=10.0)
        out = _send_and_pump(sim, sock, "POS KL204")
        assert "KL204" in out
        i = sim.traf.id2idx("KL204")
        assert float(sim.traf.state.ac.lon[i]) > 4.01   # flew east
