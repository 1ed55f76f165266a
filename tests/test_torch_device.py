"""The port's device policy and host-side gating.

* The FMS and ASAS gates, decided on the host from the state's clocks in
  their own dtype, take the same decisions as the JAX step's device
  conditionals, step for step, over 2,000 steps in float32 and float64.
* ``bluesky_tpu_torch`` imports with ``jax``, ``flax`` and ``bluesky_tpu``
  blocked.
* Entry points called without ``device`` raise when no CUDA device
  exists instead of running on the CPU.
* The server side (``network.server``, ``client``, ``journal``, ``ha``,
  ``mitigate``) imports with ``jax`` and ``bluesky_tpu`` blocked, and
  ``journal``, ``ha`` and ``mitigate`` with ``zmq`` and ``msgpack``
  blocked too.  A worker spawned by a server whose config has no
  ``device`` key exits non-zero on a host without CUDA, and the server
  reports it dead; it never runs on the CPU.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import step as jstep
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu_torch.core import asas as tasas, state as tstate, \
    step as tstep
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic

from torch_parity import scene

NSTEPS = 2000


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_gates_follow_the_jax_step(dtype, monkeypatch):
    """Both steps run 2,000 times on a 4-aircraft scene under the default
    ``SimConfig()`` (dense in both packages); after every step the clocks
    (simt, fms_t0, asas_tnext) are bit-equal, so every FMS and ASAS
    decision was the same.  The port's CD intervals (dense and blockwise)
    are replaced by a counter (the gate, not the CD, is under test)."""
    lat, lon, hdg, alt, spd = scene(4, seed=2)
    jt = JTraffic(nmax=8, dtype=getattr(jnp, dtype), pair_matrix=True)
    jt.create(4, "B744", alt, spd, None, lat, lon, hdg)
    jt.flush()
    tt = TTraffic(nmax=8, dtype=getattr(torch, dtype), device="cpu")
    tt.create(4, "B744", alt, spd, None, lat, lon, hdg)
    tt.flush()

    runs = []

    def fake_update(state, cfg, block=512, impl="lax", smooth=None):
        runs.append(float(state.simt))
        return state, None
    monkeypatch.setattr(tasas, "update", fake_update)
    monkeypatch.setattr(tasas, "update_tiled", fake_update)

    js, ts = jt.state, tt.state
    jcfg = jstep.SimConfig()                      # dense: cheap at N=4
    tcfg = tstep.SimConfig()
    assert tcfg.cd_backend == jcfg.cd_backend == "dense"
    fms = 0
    for _ in range(NSTEPS):
        js = jstep.run_steps(js, jcfg, 1)
        t0 = ts.fms_t0
        ts = tstep.step(ts, tcfg)
        fms += ts.fms_t0 != t0
        for k in ("simt", "fms_t0", "asas_tnext"):
            a, b = np.asarray(getattr(js, k)), getattr(ts, k)
            assert a.dtype == b.dtype and a == b, k
    assert len(runs) == int(round(float(ts.asas_tnext)))
    assert len(runs) >= 99 and fms >= 98


def test_import_without_jax():
    """The package and every module of it (the chunk graphs, the ``obs``
    instruments and ``obs.devprof``, ``utils.profiler``, the sparse
    and pallas CD, the Simulation with its stack, routes, navdb, guard
    and multi-world batch, the differentiable mode, the shard modes'
    ``parallel.sharding``, the worker's ``network`` modules, ScreenIO,
    the sim nodes and ``__main__``, the SO6 converter, the BS and BADA
    models and every plugin file among them, the radar, the browser UI
    and the GUI client mirror) import with jax, flax and bluesky_tpu
    unavailable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'bluesky_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import bluesky_tpu_torch as p\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    seen.add(m.name)\n"
        "need = {'bluesky_tpu_torch.' + m for m in (\n"
        "    'ops.cd', 'ops.hostgeo', 'core.trails', 'core.traffic',\n"
        "    'core.graph', 'core.route', 'core.conditional', 'core.metrics',\n"
        "    'obs.scanstats', 'obs.fingerprint', 'obs.metrics', 'obs.trace',\n"
        "    'obs.devprof', 'utils.profiler', 'ops.geo', 'ops.aero',\n"
        "    'ops.cd_sched', 'ops.cd_pallas',\n"
        "    'utils.units', 'utils.signalslot', 'utils.timer',\n"
        "    'utils.areafilter', 'utils.datalog', 'utils.plotter',\n"
        "    'navdb', 'navdb.builtin_data', 'navdb.loaders',\n"
        "    'navdb.navdatabase', 'stack.argparser', 'stack.synthetic',\n"
        "    'stack.stack', 'stack.commands', 'simulation.pipeline',\n"
        "    'simulation.snapshot', 'simulation.sim', 'simulation.worlds',\n"
        "    'fault.guard', 'diff', 'diff.smooth', 'diff.objectives',\n"
        "    'diff.optimize', 'ops.ties', 'parallel', 'parallel.sharding',\n"
        "    'settings', '__main__', 'network', 'network.common',\n"
        "    'network.npcodec', 'network.detached', 'network.node',\n"
        "    'network.node_mt', 'network.discovery', 'network.tcpserver',\n"
        "    'simulation.screenio', 'simulation.simnode', 'utils.so6',\n"
        "    'models.fwparser', 'models.coeff_bada', 'models.coeff_bs',\n"
        "    'models.synthetic', 'ops.perf_legacy', 'ops.perf_bada',\n"
        "    'plugins', 'plugins.example', 'plugins.area',\n"
        "    'plugins.sectorcount', 'plugins.geovector', 'plugins.trafgen',\n"
        "    'plugins.ilsgate', 'plugins.stackcheck', 'plugins.ensemble',\n"
        "    'plugins.opensky', 'plugins.adsbfeed', 'plugins.windgfs',\n"
        "    'ui', 'ui.palette', 'ui.polytools', 'ui.console', 'ui.radar',\n"
        "    'ui.radarclick', 'ui.web', 'network.guiclient')}\n"
        "assert need <= seen, need - seen\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'bluesky_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_detached_path_imports_without_zmq_or_msgpack():
    """The detached worker's modules (``simulation.simnode`` for
    ``DetachedSimNode``, ``simulation.screenio``, ``__main__``,
    ``network`` with ``common``, ``detached`` and ``tcpserver``) import
    with zmq and msgpack blocked as well, as on a machine without them;
    the networked modules then fail to import, naming what they lack."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'bluesky_tpu', 'zmq', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "for m in ('simulation.simnode', 'simulation.screenio', "
        "'__main__', 'network', 'network.common', 'network.detached', "
        "'network.tcpserver', 'settings'):\n"
        "    importlib.import_module('bluesky_tpu_torch.' + m)\n"
        "from bluesky_tpu_torch.simulation.simnode import DetachedSimNode\n"
        "for m in ('network.node', 'network.node_mt', 'network.npcodec', "
        "'network.discovery'):\n"
        "    try:\n"
        "        importlib.import_module('bluesky_tpu_torch.' + m)\n"
        "    except ImportError as e:\n"
        "        assert 'zmq' in str(e) or 'msgpack' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'bluesky_tpu', 'zmq', 'msgpack') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTraffic(nmax=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.make_state(8)
    from bluesky_tpu_torch.simulation.sim import Simulation
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(nmax=8)
    tree = tstate.state_to_numpy(tstate.make_state(8, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.state_from_numpy(tree)
    assert TTraffic(nmax=8, device="cpu").state.device.type == "cpu"
    assert Simulation(nmax=8, device="cpu").traf.state.device.type == "cpu"
    from bluesky_tpu_torch import settings
    from bluesky_tpu_torch.simulation.simnode import DetachedSimNode
    assert settings.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        DetachedSimNode(nmax=8)
    monkeypatch.setattr(settings, "device", "cpu")
    assert DetachedSimNode(nmax=8).sim.traf.state.device.type == "cpu"
    from bluesky_tpu_torch.diff import optimize as topt
    with pytest.raises(RuntimeError, match="CUDA"):
        topt.conflict_scene(4)
    offsets = {"lateral": np.zeros(4), "tshift": np.zeros(4)}
    with pytest.raises(RuntimeError, match="CUDA"):
        topt.OffsetParams.from_numpy(offsets)
    traf, _ = topt.conflict_scene(4, device="cpu")
    assert traf.state.device.type == "cpu"
    assert topt.OffsetParams.from_numpy(offsets, "cpu").lateral.device.type \
        == "cpu"


@pytest.mark.parametrize("backend", ["dense", "tiled", "pallas", "sparse"])
def test_unported_backends_raise(backend):
    """Every resolver runs on every backend on the CPU (one step and the
    interval itself, here with nothing in conflict); an unknown
    ``reso_method`` raises ``ValueError``, and so does the dense backend
    on a state without ``resopairs``, as in JAX."""
    ts = TTraffic(nmax=8, device="cpu").state
    impl = tasas.impl_for_backend(backend)
    for method in ("MVP", "EBY", "SWARM", "SSD"):
        acfg = tasas.AsasConfig(reso_method=method)
        out = tstep.step(ts, tstep.SimConfig(asas=acfg, cd_backend=backend))
        assert int(out.asas.nconf_cur) == 0
        if backend == "dense":
            tasas.update(ts, acfg)
        else:
            tasas.update_tiled(ts, acfg, impl=impl)
    bad = tasas.AsasConfig(reso_method="VO")
    with pytest.raises(ValueError, match="reso_method"):
        tstep.step(ts, tstep.SimConfig(asas=bad, cd_backend=backend))
    with pytest.raises(ValueError, match="reso_method"):
        if backend == "dense":
            tasas.update(ts, bad)
        else:
            tasas.update_tiled(ts, bad, impl=impl)
    no_pairs = TTraffic(nmax=8, pair_matrix=False, device="cpu").state
    cfg = tstep.SimConfig(cd_backend=backend)
    if backend == "dense":
        with pytest.raises(ValueError, match="pair_matrix"):
            tstep.step(no_pairs, cfg)
    else:
        tstep.step(no_pairs, cfg)


def test_server_side_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'bluesky_tpu'):\n"
        "    sys.modules[m] = None\n"
        "for m in ('server', 'client', 'journal', 'ha', 'mitigate'):\n"
        "    importlib.import_module('bluesky_tpu_torch.network.' + m)\n"
        "from bluesky_tpu_torch.network import packb, unpackb\n"
        "assert unpackb(packb({'a': 1})) == {'a': 1}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'bluesky_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "for m in ('jax', 'flax', 'bluesky_tpu'):\n"
        "    del sys.modules[m]\n"
        "for m in list(sys.modules):\n"
        "    if m.startswith(('bluesky_tpu_torch', 'zmq', 'msgpack')):\n"
        "        del sys.modules[m]\n"
        "for m in ('jax', 'flax', 'bluesky_tpu', 'zmq', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "for m in ('journal', 'ha', 'mitigate'):\n"
        "    importlib.import_module('bluesky_tpu_torch.network.' + m)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_spawned_worker_without_device_is_counted_dead(tmp_path):
    """A server whose config file has no ``device`` key spawns a worker
    that asks for CUDA; on this host it raises and exits non-zero before
    it registers, and the server reports the death.  No worker runs on
    the CPU."""
    import os
    import signal
    import time
    if torch.cuda.is_available():
        pytest.skip("the host has CUDA: the worker would run there")
    from tests.test_network import free_ports
    ev, st, wev, wst, disc = free_ports(5)
    cfg = tmp_path / "nodevice.cfg"
    cfg.write_text(
        f"telnet_port = 0\nevent_port = {ev}\nstream_port = {st}\n"
        f"wevent_port = {wev}\nwstream_port = {wst}\n"
        f"discovery_port = {disc}\nmax_nnodes = 1\n"
        f"log_path = {str(tmp_path / 'log')!r}\n")
    log = tmp_path / "server.log"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=repo)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bluesky_tpu_torch", "--headless",
             "--config-file", str(cfg)], stdout=out,
            stderr=subprocess.STDOUT, cwd=repo, env=env,
            start_new_session=True)
    try:
        t0 = time.monotonic()
        while "died before registering" not in log.read_text() \
                and time.monotonic() - t0 < 90 and proc.poll() is None:
            time.sleep(0.2)
        text = log.read_text()
        assert "died before registering (exit 1)" in text, text
        assert "RuntimeError" in text and "CUDA" in text, text
        assert "kernel launches" not in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.wait(timeout=30)
