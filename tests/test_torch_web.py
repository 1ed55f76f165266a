"""The port's browser UI (``bluesky_tpu_torch/ui/web.py``) on the CPU,
after JAX's ``tests/test_web.py``: ``serve_sim(run=False)`` on a
``Simulation(device="cpu")`` with a sim thread that pumps the backend
and steps the sim, on free ports.

* The page, a frame, a command round trip whose aircraft is in the next
  frame, SSE frames, radar clicks (position, callsign, a completing
  PAN whose view the next frame honours), the ND inset, the plot sheet
  and Tab completion.
* Only the sim thread renders: once a loop pumps, ``frame()`` serves
  the cache or a placeholder, never a render of its own.
* ``--web --attach``: ``ClientBackend`` over the port's ``GuiClient``
  on the port's server with a CPU ``SimNode``, in process and as
  ``python -m bluesky_tpu_torch --web --attach`` in a subprocess, which
  stops on SIGINT; and ``ClientBackend`` against a stub client.

Every wait polls with a deadline; nothing sleeps a fixed time.
"""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bluesky_tpu_torch.simulation.sim import Simulation
from bluesky_tpu_torch.ui import web
from bluesky_tpu_torch.ui.web import ClientBackend, SimBackend, WebUI

import torch_parity  # noqa: F401  (torch at one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def poll(cond, timeout=20.0, every=0.02):
    """``cond()``'s first truthy value within ``timeout`` s, else the
    last value."""
    t0 = time.monotonic()
    while True:
        v = cond()
        if v or time.monotonic() - t0 > timeout:
            return v
        threading.Event().wait(every)


class Served:
    """``serve_sim(run=False)`` and the sim thread standing in for its
    loop: it pumps the backend and runs the steps a test asks for."""

    def __init__(self):
        self.sim = Simulation(nmax=16, dtype=torch.float64, device="cpu")
        self.ui = web.serve_sim(self.sim, port=0, fps=8.0, run=False)
        self.backend = self.ui.backend
        self.steps = queue.Queue()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while not self.stop.is_set():
            self.backend.pump()
            try:
                n, done = self.steps.get_nowait()
            except queue.Empty:
                self.stop.wait(0.01)
                continue
            for _ in range(n):
                self.sim.step(max_chunk=4)
            done.set()

    def step(self, n):
        done = threading.Event()
        self.steps.put((n, done))
        assert done.wait(60)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)
        self.ui.stop()


@pytest.fixture()
def served():
    s = Served()
    yield s
    s.close()
    assert not s.thread.is_alive()


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read()


def _post(port, path, body, timeout=15):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def test_page_and_frame(served):
    page = _get(served.ui.port, "/").decode()
    assert "EventSource" in page and "/cmd" in page
    assert _get(served.ui.port, "/frame.svg").decode().startswith("<svg")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(served.ui.port, "/nosuch")
    assert e.value.code == 404


def test_command_roundtrip_and_next_frame(served):
    port = served.ui.port
    out = _post(port, "/cmd", "CRE KL204 B744 52 4 90 FL200 250")
    assert "Unknown" not in out
    # the command re-renders on the sim thread before it answers
    assert 'data-acid="KL204"' in _get(port, "/frame.svg").decode()
    assert "KL204" in _post(port, "/cmd", "POS KL204")
    assert "Unknown command" in _post(port, "/cmd", "NOSUCH")


def test_sse_frames_flow(served):
    port = served.ui.port
    _post(port, "/cmd", "CRE SSE1 B744 52 4 90 FL200 250")
    req = urllib.request.urlopen(f"http://127.0.0.1:{port}/events",
                                 timeout=10)
    frames, buf = [], b""
    t0 = time.monotonic()
    try:
        while len(frames) < 2 and time.monotonic() - t0 < 10:
            chunk = req.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                raw, buf = buf.split(b"\n\n", 1)
                if raw.startswith(b"data: "):
                    frames.append(json.loads(raw[6:]))
    finally:
        req.close()
    assert len(frames) >= 2
    for f in frames:
        assert f["svg"].startswith("<svg") and "SSE1" in f["svg"]
        assert "ntraf 1" in f["info"] and "nd" not in f


def test_radar_click_to_command(served):
    port = served.ui.port
    _post(port, "/cmd", "CRE KL204 B744 52 4 90 FL200 250")
    svg = _get(port, "/frame.svg").decode()
    assert "data-extent=" in svg and 'data-acid="KL204"' in svg

    def click(line, lat, lon):
        return json.loads(_post(port, "/click", json.dumps(
            {"line": line, "lat": lat, "lon": lon})))

    assert click("CRE AB1 B744 ", 52.5, 4.5)["todisplay"] \
        .startswith("52.5")
    assert click("", 52.0, 4.0)["todisplay"] == "KL204 "
    out = click("PAN ", 51.8, 3.9)
    assert out["tostack"].startswith("PAN") and out["todisplay"] \
        .endswith("\n")
    bad = json.loads(_post(port, "/click", '{"line": ""}'))
    assert "click error" in bad["echo"]

    def centre():
        ext = _get(port, "/frame.svg").decode().split('data-extent="')[1]
        lat0, lat1 = (float(v) for v in ext.split('"')[0].split(",")[:2])
        return abs((lat0 + lat1) / 2 - 51.8) < 0.2

    assert poll(centre)                       # PAN centre honoured


def test_nd_inset_flows_when_selected(served):
    port = served.ui.port
    _post(port, "/cmd", "CRE OWN B744 52 4 45 FL200 250")
    _post(port, "/cmd", "CRE TFC1 A320 52.2 4.2 225 FL210 230")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nd.svg")
    assert e.value.code == 404
    _post(port, "/cmd", "ND OWN")
    nd = _get(port, "/nd.svg").decode()
    assert "<svg" in nd and "TFC1 +010" in nd and "GS" in nd


def test_plot_sheet_flows(served):
    port = served.ui.port
    for line in ("CRE P1 B744 52 4 90 FL200 150", "SPD P1 290",
                 "PLOT simt ac.tas[0] 0.1", "OP", "FF"):
        _post(port, "/cmd", line)
    assert "no plots" in _get(port, "/plots.svg").decode()
    served.step(10)

    def sheet():
        _get(port, "/frame.svg")          # a viewer pulls: pump renders
        try:
            return _get(port, "/plots.svg").decode()
        except urllib.error.HTTPError:
            return ""
    svg = poll(lambda: "polyline" in sheet() and sheet())
    assert "<svg" in svg and "tas" in svg


def test_tab_completion(served):
    port = served.ui.port

    def complete(line):
        return json.loads(_post(port, "/complete", line))

    out = complete("CR")
    assert out["line"] == "CRE" and "CRECONFS" in out["hint"]
    assert complete("ZOO")["line"] == "ZOOM "
    assert complete("QQQ") == {"line": "QQQ", "hint": ""}
    assert "demo-super8.scn" in complete("IC demo-s")["hint"]
    assert complete("CRE KL1 B744")["line"] == "CRE KL1 B744"
    assert complete("IC demo-wall.scn 60")["line"] == "IC demo-wall.scn 60"


def test_completion_matches_jax():
    """``_complete_line`` and the cycling ``_backend_complete`` answer as
    JAX's on the same dictionary and scenario files."""
    from bluesky_tpu.ui import web as jweb
    sim = Simulation(nmax=8, device="cpu")

    class B:
        pass
    tb, jb = B(), B()
    for line in ("CR", "ZOO", "Q", "", "IC demo", "IC demo", "IC x",
                 "BATCH demo-s", "CRE A B"):
        assert web._complete_line(line, sim.stack) \
            == jweb._complete_line(line, sim.stack), line
        assert web._backend_complete(tb, line, sim.stack) \
            == jweb._backend_complete(jb, line, sim.stack), line


def test_frame_renders_in_place_only_before_a_loop_pumps():
    sim = Simulation(nmax=8, device="cpu")
    sim.stack.stack("CRE KL1 B744 52 4 90 FL200 250")
    sim.stack.process()
    b = SimBackend(sim)
    renders = []
    real = b._render
    b._render = lambda: renders.append(1) or real()
    svg, info = b.frame()                    # idle, nothing pumps
    assert "KL1" in svg and renders == [1]
    b._render = lambda: (_ for _ in ()).throw(ValueError("render bug"))
    b.pump()                                 # a loop: keeps no frame
    assert b._frame is None
    assert b.frame() == web._NO_FRAME        # no render off the loop


def test_render_bugs_are_counted_and_device_faults_raise(caplog):
    """A drawing bug in ``pump`` keeps the last good frame, is logged
    and counts in ``pipe_stats["render_errors"]``; a ``RuntimeError``
    (torch's and CUDA's faults, first seen in the state's copy) goes up
    to the loop."""
    sim = Simulation(nmax=8, device="cpu")
    b = SimBackend(sim)
    assert sim.pipe_stats["render_errors"] == 0
    assert sim.obs.get("ui_render_errors") is None   # made on first count
    b.pump()
    good = b._frame
    assert good is not None and sim.pipe_stats["render_errors"] == 0
    b._render = lambda: (_ for _ in ()).throw(KeyError("glyph"))
    b._pending.put(("cmd", "ECHO hi", queue.Queue()))
    with caplog.at_level("ERROR", logger=web.__name__):
        b.pump()                             # a command forces a render
    assert b._frame is good
    assert sim.pipe_stats["render_errors"] == 1
    assert "radar render failed" in caplog.text
    b._render = lambda: (_ for _ in ()).throw(
        RuntimeError("CUDA error: an illegal memory access"))
    b._pending.put(("cmd", "ECHO hi", queue.Queue()))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        b.pump()
    assert sim.pipe_stats["render_errors"] == 1


def test_render_period_runs_from_the_end_of_a_render(monkeypatch):
    """With a viewer pulling and renders slower than ``render_period``,
    the sim thread keeps the period for its own work between renders:
    on a fake clock, 0.3 s renders and 0.05 s of stepping a loop turn
    render at most every sixth pump, not at every pump."""
    sim = Simulation(nmax=8, device="cpu")
    b = SimBackend(sim)
    clock = [100.0]
    monkeypatch.setattr(web.time, "monotonic", lambda: clock[0])
    renders = []

    def slow_render():
        renders.append(clock[0])
        clock[0] += 0.3
        return "<svg/>", ""
    b._render = slow_render
    b.pump()                                  # seeds the cache
    for _ in range(60):
        b.frame()                             # a viewer pulls
        b.pump()
        clock[0] += 0.05                      # the loop's chunk
    gaps = np.diff(renders)
    assert len(renders) <= 1 + 60 // 6 and len(renders) > 5
    assert (gaps >= 0.3 + b.render_period - 1e-9).all()


# ----------------------------------------------------------- --web --attach
zmq = pytest.importorskip("zmq")


class Fabric:
    """The port's server in a thread and one CPU ``SimNode`` thread, on
    free ports."""

    def __init__(self, tmp_path):
        from bluesky_tpu_torch.network.server import Server
        from bluesky_tpu_torch.simulation.simnode import SimNode
        from tests.test_network import free_ports
        self.ev, self.st, wev, wst = free_ports(4)
        self.server = Server(headless=True, spawn_workers=False,
                             ports=dict(event=self.ev, stream=self.st,
                                        wevent=wev, wstream=wst),
                             journal_path=str(tmp_path / "b.jsonl"))
        self.server.start()
        self.node = SimNode(event_port=wev, stream_port=wst, nmax=16,
                            device="cpu")
        self.thread = threading.Thread(target=self.node.run, daemon=True)
        self.thread.start()

    def close(self):
        self.node.quit()
        self.thread.join(timeout=10)
        self.server.stop()
        self.server.join(timeout=10)


@pytest.fixture()
def fabric(tmp_path):
    f = Fabric(tmp_path)
    yield f
    f.close()


def test_web_attach_in_process(fabric):
    from bluesky_tpu_torch.network.guiclient import GuiClient
    client = GuiClient()
    client.connect(event_port=fabric.ev, stream_port=fabric.st,
                   timeout=5.0)
    ui, stop, pt = None, threading.Event(), None
    try:
        assert poll(lambda: (client.receive(10), len(client.nodes))[1])
        backend = ClientBackend(client, pumped=True)
        backend.pump()
        ui = WebUI(backend, port=0).start()

        def pump():
            while not stop.is_set():
                backend.pump()
                stop.wait(0.02)
        pt = threading.Thread(target=pump, daemon=True)
        pt.start()
        _post(ui.port, "/cmd", "CRE AC1 B744 52 4 90 FL200 250")
        _post(ui.port, "/cmd", "OP")
        assert poll(lambda: b"AC1" in _get(ui.port, "/frame.svg"),
                    timeout=60)
        assert "Info on AC1" in _post(ui.port, "/cmd", "POS AC1",
                                      timeout=20)
        out = json.loads(_post(ui.port, "/click", json.dumps(
            {"line": "PAN ", "lat": 52.1, "lon": 4.2})))
        assert out["todisplay"] == "52.1000,4.2000 "
    finally:
        stop.set()
        if pt is not None:
            pt.join(timeout=10)
        if ui is not None:
            ui.stop()
        client.close()


def test_web_attach_subprocess(fabric, tmp_path):
    from tests.test_network import free_ports
    (wport,) = free_ports(1)
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bluesky_tpu_torch", "--web", "--attach",
         "--event-port", str(fabric.ev), "--stream-port", str(fabric.st),
         "--web-port", str(wport)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        def page():
            try:
                return _get(wport, "/", timeout=2)
            except OSError:
                return b""
        assert b"EventSource" in poll(page, timeout=60)
        _post(wport, "/cmd", "CRE AT1 B744 52 4 90 FL200 250")
        _post(wport, "/cmd", "OP")
        assert poll(lambda: b'data-acid="AT1"' in _get(wport, "/frame.svg"),
                    timeout=60)
    finally:
        proc.send_signal(signal.SIGINT)
        out = proc.communicate(timeout=30)[0]
    assert proc.returncode == 0, out
    assert f"attached to 127.0.0.1) on http://127.0.0.1:{wport}/" in out


def test_client_backend_interface():
    """ClientBackend against a stub with the GuiClient surface it uses
    (get_nodedata().echo_text, stack, receive, render_svg, act)."""

    class Node:
        def __init__(self):
            self.echo_text = []
            self.acdata = {"id": ["X1"]}
            self.nd_acid = None

    class StubClient:
        def __init__(self):
            self.nd = Node()
            self.act = b"node1"

        def get_nodedata(self, nodeid=None):
            return self.nd

        def stack(self, line, target=None):
            self.nd.echo_text.append(f"ok: {line}")

        def receive(self, timeout_ms=0):
            return 0

        def render_svg(self, fname=None, nodeid=None):
            return "<svg>stub</svg>"

    b = ClientBackend(StubClient())
    svg, info = b.frame()
    assert svg.startswith("<svg") and "ntraf 1" in info
    assert b.command("POS X1") == "ok: POS X1"
    assert b.nd_frame() is None
    assert b.click("", 52.0, 4.0)["todisplay"] == "52.0000,4.0000 "
