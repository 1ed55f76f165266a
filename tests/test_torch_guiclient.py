"""The port's GUI client mirror (``bluesky_tpu_torch/network/
guiclient.py``) on the CPU, after JAX's ``tests/test_ui.py::
TestGuiClient``: the port's server in a thread, one CPU ``SimNode``
thread and two GUI clients on free ports, the port's and JAX's, fed the
same streams.

* The port's ``GuiClient`` mirrors the node: the aircraft frame, the
  accumulated trails, the shape registry (a BOX, and its deletion), the
  DEFWPT and DISPLAYFLAG mirrors (SSD, SHOWND, SYM), the echoes and the
  sim info; ``render_svg`` draws the mirror.
* JAX's ``GuiClient`` on the same server holds the same ACDATA, trails,
  shapes and sim info once both have the node's last frame, and both
  clients draw the same picture (numbers within 1e-9 where the float
  text differs); the port's ``nodeData`` and JAX's give the same
  mirror for the same events and streams fed by hand.

Every wait polls with a deadline.
"""
import threading
import time

import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from bluesky_tpu.network.guiclient import GuiClient as JGuiClient
from bluesky_tpu.network.guiclient import nodeData as JNodeData
from bluesky_tpu_torch.network.guiclient import GuiClient as TGuiClient
from bluesky_tpu_torch.network.guiclient import nodeData as TNodeData
from bluesky_tpu_torch.network.server import Server
from bluesky_tpu_torch.simulation.simnode import SimNode
from tests.test_network import free_ports

from torch_parity import assert_svg_close


def poll(cond, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
    return False


@pytest.fixture()
def fabric(tmp_path):
    ev, st, wev, wst = free_ports(4)
    server = Server(headless=True, spawn_workers=False,
                    ports=dict(event=ev, stream=st, wevent=wev,
                               wstream=wst),
                    journal_path=str(tmp_path / "b.jsonl"))
    server.start()
    node = SimNode(event_port=wev, stream_port=wst, nmax=16, device="cpu")
    thread = threading.Thread(target=node.run, daemon=True)
    thread.start()
    clients = [TGuiClient(), JGuiClient()]
    try:
        for c in clients:
            c.connect(event_port=ev, stream_port=st, timeout=5.0)
        yield clients
    finally:
        for c in clients:
            c.close()
        node.quit()
        thread.join(timeout=10)
        server.stop()
        server.join(timeout=10)
    assert not thread.is_alive()


def _recv(*clients):
    for c in clients:
        c.receive(5)


def test_mirror_over_the_port_server(fabric):
    tc, jc = fabric
    assert poll(lambda: (_recv(tc, jc), len(tc.nodes) and len(jc.nodes))[1])
    (nid,) = list(tc.nodes)
    tnd, jnd = tc.get_nodedata(nid), jc.get_nodedata(nid)
    assert poll(lambda: (_recv(tc, jc), "simt" in tnd.acdata
                         and "simt" in jnd.acdata)[1])
    for line in ("CRE KL204 B744 52 4 90 FL200 250",
                 "CRE PH808 A320 52.01 4.6 268 FL205 230", "ASAS ON",
                 "RESO OFF",
                 "BOX SECT 51 3 53 5", "BOX GONE 50 3 50.5 3.5",
                 "DEFWPT UIWPT 52.2 4.1", "SWRAD SYM", "TRAIL ON 1",
                 "SSD CONFLICTS", "ND KL204", "POS KL204", "OP", "FF"):
        tc.stack(line)
    assert poll(lambda: (_recv(tc, jc),
                         len(np.atleast_1d(tnd.traillat0)) >= 6)[1], 60)
    tc.stack("DEL GONE")
    tc.stack("HOLD")
    # both hold the node's last frame: the sim time stops moving
    last = {}

    def settled():
        _recv(tc, jc)
        key = (tnd.acdata.get("simt"), jnd.acdata.get("simt"))
        if key[0] != key[1] or key != last.get("k"):
            last.update(k=key, t=time.monotonic())
            return False
        return time.monotonic() - last["t"] > 1.0
    assert poll(settled, 60)

    assert tnd.acdata["id"] == ["KL204", "PH808"]
    assert "SECT" in tnd.shapes and "GONE" not in tnd.shapes
    assert tnd.custwpts["UIWPT"] == (52.2, 4.1)
    assert "SYM" in tnd.flags and tnd.ssd_conflicts
    assert tnd.nd_acid == "KL204"
    assert any("KL204" in t for t in tnd.echo_text)
    assert tnd.siminfo.get("ntraf") == 2
    svg = tc.render_svg()
    assert 'data-acid="KL204"' in svg and "SECT" in svg
    assert tnd.acdata["inconf"].all()          # the pair converges
    assert svg.count('class="ssd"') == 2

    # JAX's client on the same streams
    assert sorted(tnd.acdata) == sorted(jnd.acdata)
    for k, v in tnd.acdata.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, jnd.acdata[k]), k
        else:
            assert v == jnd.acdata[k], k
    for k in ("traillat0", "traillon0", "traillat1", "traillon1"):
        assert np.array_equal(getattr(tnd, k), getattr(jnd, k)), k
    assert tnd.shapes == jnd.shapes and tnd.siminfo == jnd.siminfo
    jnd.ssd_conflicts = tnd.ssd_conflicts    # DISPLAYFLAG goes to the
    #                                          sender (the port client)
    assert_svg_close(svg, jc.render_svg(nodeid=nid))


EVENTS = [
    (b"ECHO", {"text": "hello"}),
    (b"SHAPE", {"name": "A", "shape": "POLY",
                "coordinates": [52, 4, 53, 4, 53, 5]}),
    (b"SHAPE", {"name": "B", "shape": "CIRCLE", "coordinates": [52, 4, 5]}),
    (b"SHAPE", {"name": "A", "coordinates": None}),
    (b"DEFWPT", {"name": "W1", "lat": 52.5, "lon": 4.5}),
    (b"DISPLAYFLAG", {"flag": "SSD", "args": ["AC1"]}),
    (b"DISPLAYFLAG", {"flag": "SSD", "args": ["AC2"]}),
    (b"DISPLAYFLAG", {"flag": "SSD", "args": ["AC1"]}),
    (b"DISPLAYFLAG", {"flag": "SHOWND", "args": "AC2"}),
    (b"DISPLAYFLAG", {"flag": "SYM", "args": None}),
]


def _frame(k, trails, swtrails=True):
    return {"simt": 1.0 * k, "id": ["AC1", "AC2"],
            "lat": np.array([52.0, 52.1]) + 0.01 * k,
            "lon": np.array([4.0, 4.2]), "trk": np.array([90.0, 200.0]),
            "alt": np.array([6000.0, 6500.0]),
            "gs": np.array([120.0, 130.0]),
            "inconf": np.array([True, True]),
            "traillat0": np.full(trails, 52.0 + k),
            "traillon0": np.full(trails, 4.0),
            "traillat1": np.full(trails, 52.1 + k),
            "traillon1": np.full(trails, 4.1), "swtrails": swtrails}


def test_node_data_feeds_equal(monkeypatch):
    """The same events and streams fed by hand to the port's client and
    JAX's give the same mirrors and pictures, the trail cap and the
    trails-off reset included."""
    monkeypatch.setattr(TNodeData, "MAX_TRAIL_SEGMENTS", 5)
    monkeypatch.setattr(JNodeData, "MAX_TRAIL_SEGMENTS", 5)
    tc, jc = TGuiClient.__new__(TGuiClient), JGuiClient.__new__(JGuiClient)
    for c, cls in ((tc, TNodeData), (jc, JNodeData)):
        from collections import defaultdict
        c.nodedata = defaultdict(cls)
        c.act = b"n1"
        c.actnode = lambda node_id=None: b"n1"
    streams = [(b"SIMINFO", {"simt": 3.0, "ntraf": 2, "speed": 1.0}),
               (b"ROUTEDATA", {"acid": "AC1", "wplat": [52.3],
                               "wplon": [4.4], "wpname": ["W1"]}),
               (b"ACDATA", _frame(1, 3)), (b"ACDATA", _frame(2, 4)),
               (b"ACDATA", _frame(3, 0)), (b"ROUTEDATA", {"wplat": []}),
               (b"ACDATA", _frame(4, 2, swtrails=False)),
               (b"ACDATA", _frame(5, 2))]
    seen = []
    for name, data in EVENTS:
        for c in (tc, jc):
            c._on_event(name, data, b"n1")
    for name, data in streams:
        for c in (tc, jc):
            c._on_stream(name, data, b"n1")
        t, j = tc.get_nodedata(), jc.get_nodedata()
        seen.append(len(t.traillat0))
        for k in ("traillat0", "traillon0", "traillat1", "traillon1"):
            assert np.array_equal(getattr(t, k), getattr(j, k)), (name, k)
        assert t.routedata == j.routedata
        assert tc.render_svg() == jc.render_svg()
    t, j = tc.get_nodedata(), jc.get_nodedata()
    assert seen == [0, 0, 3, 5, 5, 5, 0, 2]
    for k in ("shapes", "echo_text", "custwpts", "flags", "ssd_all",
              "ssd_conflicts", "ssd_ownship", "nd_acid", "siminfo"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.ssd_ownship == {"AC2"} and t.nd_acid == "AC2"
