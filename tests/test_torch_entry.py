"""The port's entry point (``python -m bluesky_tpu_torch``) and its
settings, on the CPU.

* ``--detached --config-file cfg --scenfile scn`` in a subprocess, the
  config asking for the CPU and no telnet bridge, runs the scenario to
  its QUIT with exit 0 and leaves the scenario's SNAPSHOT at the sim
  time and fleet the scenario gives; without that key and without CUDA
  it raises instead of running on the CPU.
* ``--help`` lists every mode; ``--attach`` without ``--web`` exits 2
  with the JAX package's message; ``--web`` with a CPU config file
  serves the radar in a subprocess and stops on SIGINT, and without
  that key and without CUDA raises; ``--sim`` without pyzmq fails
  naming it.
* ``--headless`` and the default mode start the port's server in a
  subprocess on the config file's ports; it spawns a torch worker with
  the same config file (a CPU worker here), and SIGTERM stops both with
  exit 0, the worker naming its kernel launches as it leaves.
  ``--client`` sends a stdin line to a worker and prints its ECHO.
* ``DetachedSimNode`` and ``__main__`` import with ``zmq`` and
  ``msgpack`` blocked (a machine may have neither).
* ``settings.init`` and ``set_variable_defaults`` give JAX's values on
  the same file, and ``init`` records the file it loaded; every key the
  server side reads has JAX's default.
* The detached worker's telnet bridge starts on a free port and stops
  with the loop.
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = ("--headless", "--sim", "--detached", "--client", "--web",
         "--upstream", "--node-id", "--import-navdata", "--config-file",
         "--scenfile", "--attach", "--standby", "--resume-batch")


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.update(kw)
    return env


def _scenario(tmp_path, tend=5):
    scn = tmp_path / "run.scn"
    snap = tmp_path / "end.snap"
    scn.write_text(
        "00:00:00.00>CRE KL1 B744 52 4 90 FL200 250\n"
        "00:00:00.00>CRE KL2 B744 52.1 4 270 FL200 250\n"
        "00:00:00.00>OP\n"
        "00:00:00.00>FF\n"
        f"00:00:{tend:02d}.00>SNAPSHOT SAVE {snap}\n"
        f"00:00:{tend:02d}.00>QUIT\n")
    return scn, snap


def test_detached_scenfile_runs_to_quit(tmp_path):
    from bluesky_tpu_torch.simulation import snapshot
    scn, snap = _scenario(tmp_path)
    cfg = tmp_path / "cpu.cfg"
    cfg.write_text("device = 'cpu'\ntelnet_port = 0\n")
    out = subprocess.run(
        [sys.executable, "-m", "bluesky_tpu_torch", "--detached",
         "--config-file", str(cfg), "--scenfile", str(scn)],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Telnet" not in out.stdout
    blob, err = snapshot.read_blob(str(snap))
    assert err is None
    assert sorted(i for i in blob["ids"] if i) == ["KL1", "KL2"]
    assert snapshot.blob_simt(blob) == pytest.approx(5.0, abs=1e-6)


def test_detached_without_cuda_or_device_raises(tmp_path):
    """No config file: the default device is CUDA, which this machine
    lacks, so the worker raises before running anything."""
    scn, snap = _scenario(tmp_path)
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from bluesky_tpu_torch.__main__ import main\n"
            f"sys.exit(main(['--detached', '--scenfile', {str(scn)!r}]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=tmp_path)
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA" in out.stderr
    assert not snap.exists()


def _main(argv):
    """The port's ``main(argv)`` in-process: (exit code, stdout,
    stderr)."""
    from bluesky_tpu_torch.__main__ import main
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, so.getvalue(), se.getvalue()


def test_help_lists_all_modes():
    rc, out, _ = _main(["--help"])
    assert rc == 0
    for mode in MODES:
        assert mode in out, mode


def test_attach_requires_web():
    from bluesky_tpu.__main__ import main as jmain
    se = io.StringIO()
    with redirect_stderr(se), pytest.raises(SystemExit) as e:
        jmain(["--attach"])
    jerr = se.getvalue().splitlines()[-1]
    rc, _, err = _main(["--attach"])
    assert rc == e.value.code == 2
    assert err.splitlines()[-1].split(": error: ")[1] \
        == jerr.split(": error: ")[1]
    assert "--attach only applies to --web" in err


def test_web_serves_the_radar_and_stops_on_sigint(tmp_path):
    """``--web --config-file cpu.cfg --scenfile scn`` in a subprocess
    serves ``/`` and the scenario's radar frame, runs a posted command,
    and SIGINT stops it with exit 0."""
    import json
    import signal
    import time
    import urllib.request
    from tests.test_network import free_ports
    (port,) = free_ports(1)
    cfg = tmp_path / "cpu.cfg"
    cfg.write_text("device = 'cpu'\ntelnet_port = 0\n")
    scn = tmp_path / "web.scn"
    scn.write_text("00:00:00.00>CRE KL1 B744 52 4 90 FL200 250\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bluesky_tpu_torch", "--web", "--web-port",
         str(port), "--config-file", str(cfg), "--scenfile", str(scn)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(PYTHONUNBUFFERED="1"), cwd=tmp_path)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.read().decode()
    try:
        t0, page = time.monotonic(), ""
        while "EventSource" not in page and time.monotonic() - t0 < 120:
            try:
                page = get("/")
            except OSError:
                time.sleep(0.05)
        assert "EventSource" in page
        while 'data-acid="KL1"' not in get("/frame.svg"):
            assert time.monotonic() - t0 < 120
            time.sleep(0.05)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/complete", data=b"SCREENS",
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["line"] == "SCREENSHOT "
    finally:
        proc.send_signal(signal.SIGINT)
        out = proc.communicate(timeout=60)[0]
    assert proc.returncode == 0, out[-2000:]
    assert f"web UI on http://127.0.0.1:{port}/" in out


def test_web_without_cuda_or_device_raises(tmp_path):
    """No config file: ``--web``'s Simulation asks for CUDA, which this
    machine lacks, and raises instead of serving a CPU sim."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from bluesky_tpu_torch.__main__ import main\n"
            "sys.exit(main(['--web', '--web-port', '0']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=tmp_path)
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA" in out.stderr
    assert "web UI on" not in out.stdout


BLOCKED = ("import sys\n"
           "for m in ('zmq', 'msgpack', 'jax', 'flax', 'bluesky_tpu'):\n"
           "    sys.modules[m] = None\n")


def test_sim_without_pyzmq_names_it():
    code = BLOCKED + (
        "from bluesky_tpu_torch.__main__ import main\n"
        "sys.exit(main(['--sim']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env())
    assert out.returncode == 2
    assert "pyzmq" in out.stderr


def test_detached_path_imports_without_zmq_or_msgpack():
    code = BLOCKED + (
        "import bluesky_tpu_torch.__main__\n"
        "from bluesky_tpu_torch.simulation.simnode import DetachedSimNode\n"
        "from bluesky_tpu_torch.simulation import screenio\n"
        "from bluesky_tpu_torch.network import common, detached, tcpserver\n"
        "node = DetachedSimNode(nmax=8, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('zmq', 'msgpack') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    from bluesky_tpu_torch.simulation.simnode import SimNode\n"
        "except ImportError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


CFG = """# a settings file
device = 'cpu'
telnet_port = 0
simdt = 0.1
log_path = 'elsewhere'
world_batch_max = 3
late_key = [1, 2]
not_a_literal = some text
"""


@pytest.fixture
def both_settings(monkeypatch):
    """JAX's and the port's settings modules, restored after the test."""
    from bluesky_tpu import settings as js
    from bluesky_tpu_torch import settings as ts
    for mod in (js, ts):
        for k, v in list(vars(mod).items()):
            if not k.startswith("__") and not callable(v) \
                    and not isinstance(v, type(os)):
                monkeypatch.setattr(mod, k, v)
        monkeypatch.setattr(mod, "_overrides", dict(mod._overrides))
    for k in ("device", "late_key", "not_a_literal", "new_default",
              "simdt_default"):
        for mod in (js, ts):
            if not hasattr(mod, k):
                monkeypatch.setattr(mod, k, None, raising=False)
                monkeypatch.delattr(mod, k)
    return js, ts


def test_settings_init_matches_jax(tmp_path, both_settings):
    js, ts = both_settings
    cfg = tmp_path / "settings.cfg"
    cfg.write_text(CFG)
    assert js.init("") is ts.init("") is False
    assert js.init(str(tmp_path / "missing.cfg")) is False
    assert ts.init(str(tmp_path / "missing.cfg")) is False
    assert js.init(str(cfg)) is ts.init(str(cfg)) is True
    assert ts._overrides == js._overrides
    for k in js._overrides:
        assert getattr(ts, k) == getattr(js, k), k
    assert ts.not_a_literal == "some text" and ts.late_key == [1, 2]
    assert ts.device == "cpu" and ts.telnet_port == 0
    # the keys the worker reads have JAX's defaults
    for k in ("wevent_port", "wstream_port", "telnet_port",
              "node_watchdog_warn", "node_watchdog_kill", "stream_sndhwm",
              "mitigate_enabled", "sdc_enabled", "sdc_audit_rate",
              "ha_standby", "ha_lease_ttl", "world_pack",
              "world_batch_max", "preempt_snapshot_dir"):
        assert getattr(ts, k) == getattr(js, k), k


def test_set_variable_defaults_matches_jax(tmp_path, both_settings):
    js, ts = both_settings
    cfg = tmp_path / "settings.cfg"
    cfg.write_text(CFG)
    for mod in (js, ts):
        mod.init(str(cfg))
        # a config value wins over a late default; an existing value
        # stays; a new key takes the default
        mod.set_variable_defaults(late_key=[9], simdt=0.5,
                                  new_default="x", opt_iters=7)
    for k in ("late_key", "simdt", "new_default", "opt_iters"):
        assert getattr(ts, k) == getattr(js, k), k
    assert ts.late_key == [1, 2] and ts.new_default == "x"
    assert ts.simdt == 0.1 and ts.opt_iters == 40


def test_detached_telnet_bridge_starts_and_stops(tmp_path, monkeypatch):
    """``_serve`` starts the bridge on ``settings.telnet_port`` (0 is
    off, so the test asks for a free port through the server class),
    and the bridge's accept thread is gone when the loop ends."""
    import socket
    import threading
    from bluesky_tpu_torch import __main__ as tmain, settings as ts
    from bluesky_tpu_torch.network import tcpserver
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    monkeypatch.setattr(ts, "telnet_port", port)
    monkeypatch.setattr(ts, "device", "cpu")
    scn, snap = _scenario(tmp_path, tend=2)
    started = []
    real_start = tcpserver.StackTelnetServer.start

    def start(self):
        started.append(self)
        return real_start(self)
    monkeypatch.setattr(tcpserver.StackTelnetServer, "start", start)

    class Args:
        scenfile = str(scn)
    from bluesky_tpu_torch.simulation.simnode import DetachedSimNode
    node = DetachedSimNode(nmax=8)
    assert tmain._serve(node, Args) == 0
    assert snap.exists() and node.sim.telnet is None
    (srv,) = started
    assert srv.port == port and not srv.running
    assert not srv._accept_thread.is_alive()
    assert all(t is not srv._accept_thread for t in threading.enumerate())


def test_snapshot_marker_matches_simulation(tmp_path, monkeypatch):
    """The detached node's run to QUIT ends where an embedded
    ``Simulation`` given the same scenario ends (its state bit for
    bit)."""
    from torch_parity import no_pacing
    from bluesky_tpu_torch.core.state import state_to_numpy
    from bluesky_tpu_torch.simulation.simnode import DetachedSimNode
    from bluesky_tpu_torch.simulation.sim import Simulation
    no_pacing(monkeypatch)
    scn, snap = _scenario(tmp_path, tend=3)
    node = DetachedSimNode(nmax=8, device="cpu")
    node.sim.stack.ic(str(scn))
    node.run()
    sim = Simulation(nmax=8, device="cpu")
    sim.stack.ic(str(scn))
    sim.run(until_simt=3.0)
    sim.drain_pipeline()
    assert node.sim.simt == sim.simt
    a, b = state_to_numpy(node.sim.traf.state), state_to_numpy(
        sim.traf.state)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
    assert node.sim.state_flag == 3 and snap.exists()


@pytest.mark.parametrize("case", ["not_a_dir", "empty_dir"])
def test_import_navdata_refuses_as_jax(tmp_path, case):
    """``--import-navdata`` on a path that is no directory, or holds no
    recognized navdata file, exits 1 with the JAX package's message and
    copies nothing."""
    from bluesky_tpu.__main__ import main as jmain
    src = tmp_path / "src"
    if case == "empty_dir":
        src.mkdir()
    dest = tmp_path / "dest"
    argv = ["--import-navdata", str(src), "--dest", str(dest)]
    se = io.StringIO()
    with redirect_stderr(se), redirect_stdout(io.StringIO()):
        jrc = jmain(argv)
    rc, out, err = _main(argv)
    assert rc == jrc == 1
    assert err == se.getvalue() and out == ""
    assert not dest.exists()


# ------------------------------------------------- the server and client
SERVER_KEYS = ("max_nnodes", "batch_max_crashes", "batch_journal_fsync",
               "batch_queue_max", "batch_retry_after",
               "connect_backoff_base", "connect_backoff_cap",
               "straggler_timeout", "hedge_enabled", "hedge_rate_factor",
               "hb_busy_multiplier", "perf_slo_factor",
               "quarantine_report_cap", "journal_warn_bytes",
               "ha_standby", "ha_lease_ttl", "ha_poll_dt",
               "ha_fence_strict", "world_pack", "world_batch_max",
               "mitigate_enabled", "mitigate_budget", "mitigate_rate",
               "mitigate_rate_window", "mitigate_backoff_base",
               "mitigate_backoff_cap", "mitigate_shed_hi",
               "mitigate_shed_lo", "mitigate_shed_factor",
               "mitigate_mem_budget", "mitigate_mem_hi", "mitigate_mem_lo",
               "mitigate_repack_factor", "sdc_enabled", "sdc_audit_rate",
               "stream_sndhwm", "event_port", "stream_port",
               "wevent_port", "wstream_port", "discovery_port")


def test_server_settings_match_jax():
    """Every key the server, journal, HA, mitigation engine and client
    read has JAX's default."""
    from bluesky_tpu import settings as js
    from bluesky_tpu_torch import settings as ts
    for k in SERVER_KEYS:
        assert getattr(ts, k) == getattr(js, k), k


def test_init_records_the_config_file(tmp_path, both_settings):
    js, ts = both_settings
    cfg = tmp_path / "settings.cfg"
    cfg.write_text(CFG)
    assert ts.config_file == ""
    assert ts.init(str(cfg)) is True
    assert ts.config_file == str(cfg) and os.path.isabs(ts.config_file)
    assert "config_file" not in ts._overrides


def _fabric_cfg(tmp_path, **extra):
    from tests.test_network import free_ports
    ev, st, wev, wst, disc = free_ports(5)
    keys = dict(device="cpu", telnet_port=0, event_port=ev, stream_port=st,
                wevent_port=wev, wstream_port=wst, discovery_port=disc,
                log_path=str(tmp_path / "log"), max_nnodes=1, **extra)
    cfg = tmp_path / "fabric.cfg"
    cfg.write_text("".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return str(cfg), keys


def _wait_log(path, text, proc, timeout):
    import time
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if text in path.read_text():
            return True
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    return text in path.read_text()


@pytest.mark.parametrize("mode", [["--headless"], []],
                         ids=["headless", "default"])
def test_server_modes_spawn_a_worker_and_stop_on_sigterm(tmp_path, mode):
    import signal
    from bluesky_tpu_torch.network.client import Client
    from tests.test_network import wait_for
    cfg, keys = _fabric_cfg(tmp_path)
    log = tmp_path / "server.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bluesky_tpu_torch", *mode,
             "--config-file", cfg], stdout=out, stderr=subprocess.STDOUT,
            cwd=REPO, env=_env(PYTHONUNBUFFERED="1"),
            start_new_session=True)
    client = Client()
    try:
        assert _wait_log(log, "bluesky_tpu_torch server: clients on",
                         proc, 60), log.read_text()
        assert f"clients on {keys['event_port']}/{keys['stream_port']}, " \
            f"workers on {keys['wevent_port']}/{keys['wstream_port']}" \
            in log.read_text()
        client.connect(event_port=keys["event_port"],
                       stream_port=keys["stream_port"], timeout=10.0)
        assert wait_for(lambda: (client.receive(10),
                                 len(client.nodes) == 1)[1], timeout=120), \
            log.read_text()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()
        text = log.read_text()
        (node,) = client.nodes
        assert f"worker {node.hex()}: kernel launches {{}}" in text, text
    finally:
        client.close()
        if proc.poll() is None:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.wait(timeout=30)


def test_client_console_prints_the_echo(tmp_path, monkeypatch):
    """``--client`` on a torch server with a torch worker: a stdin line
    goes to the worker's stack and its ECHO is printed; EOF ends the
    console with exit 0."""
    import threading
    import time
    from bluesky_tpu_torch.network.server import Server
    from bluesky_tpu_torch.simulation.simnode import SimNode
    from tests.test_network import free_ports, wait_for
    ev, st, wev, wst = free_ports(4)
    server = Server(headless=True, spawn_workers=False, journal_path="",
                    ports=dict(event=ev, stream=st, wevent=wev,
                               wstream=wst))
    server.start()
    node = thread = None
    try:
        time.sleep(0.2)
        node = SimNode(event_port=wev, stream_port=wst, nmax=8,
                       device="cpu")
        thread = threading.Thread(target=node.run, daemon=True)
        thread.start()
        assert wait_for(lambda: len(server.workers) == 1, timeout=10)
        # blank lines after the command keep the console receiving
        # (10 ms a line) until the echo is in
        out = subprocess.run(
            [sys.executable, "-m", "bluesky_tpu_torch", "--client",
             "--event-port", str(ev), "--stream-port", str(st)],
            input="ECHO hello console\n" + "\n" * 300, capture_output=True,
            text=True, timeout=120, cwd=REPO, env=_env())
        assert out.returncode == 0, out.stderr
        assert "connected to " + server.server_id.hex() in out.stdout
        assert "1 node(s)" in out.stdout
        assert "hello console" in out.stdout, out.stdout
    finally:
        if node is not None:
            node.quit()
            thread.join(timeout=10)
        server.stop()
        server.join(timeout=5)
