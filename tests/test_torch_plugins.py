"""The port's plugin system and its plugins against the JAX package's,
on the CPU, with the same stack commands in both (float64, noise off).

* Discovery: the same plugins, each with the same name, type and stack
  commands read by the AST scan (no import); a non-plugin file is
  rejected; a plugin file on ``settings.plugin_path`` loads as a
  submodule of ``bluesky_tpu_torch.plugins`` and imports the framework
  relatively.
* ``PLUGINS LIST/LOAD/REMOVE``: the same replies and the same command
  table after each; a double load is refused.
* AREA deletes the same aircraft and writes the same FLSTLOG rows (times
  and floats within 1e-9); TRAFGEN spawns the same callsigns for a
  source, a drain and a gain of 0; SECTORCOUNT logs the same counts;
  GEOVECTOR clamps the speeds inside its area (within 1e-9), leaves the
  traffic outside it untouched, and DELGEOVECTOR answers the same;
  ILSGATE, OPENSKY (its poll failing offline), ADSBFEED and WINDGFS
  answer as JAX's do; EXAMPLE counts the same updates; STACKCHECK's fuzz
  raises nothing in the port.
* The Simulation's hooks: a plugin clamps the chunk to its interval and
  its due edges are synchronous (sync reason ``plugin``); with no plugin
  loaded no edge gives that reason and chunks pipeline.
* ENSEMBLE: (a) the port's stepping of given replica states (``Ensemble.
  step``) equals JAX's ``sharding.ensemble_step_fn`` on the same stacked
  sparse MVP states; (b) with the same per-replica counts the statistics
  and the reply equal JAX's; (c) the jitter meets its statistics over 64
  replicas of a 256-slot scene at 500 m.

The Simulations are module-scoped (``nmax`` 64); every case resets them.
"""
import os
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from torch_parity import jax_tree_to_numpy, partner_sets, sim_do
from bluesky_tpu.plugins import BUILTIN_PATH as JPATH
from bluesky_tpu.plugins import check_plugin as jcheck
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.plugins import BUILTIN_PATH as TPATH
from bluesky_tpu_torch.plugins import check_plugin as tcheck

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    """Each sim with a datalog registry of its own: a standalone sim
    shares its package's process-wide one, where loggers that other test
    files' plugins defined (AREA's FLSTLOG) would add their commands."""
    from bluesky_tpu.simulation.sim import Simulation as JSim
    from bluesky_tpu.utils.datalog import LogRegistry as JReg
    from bluesky_tpu_torch.simulation.sim import Simulation as TSim
    from bluesky_tpu_torch.utils.datalog import LogRegistry as TReg
    return (JSim(nmax=64, dtype=jnp.float64, datalog_registry=JReg()),
            TSim(nmax=64, dtype=torch.float64, device=CPU,
                 datalog_registry=TReg()))


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    """No wall-clock pacing; each package's logs in a folder of its own;
    no plugin poll reaches the network."""
    import time
    from bluesky_tpu import settings as js
    from bluesky_tpu_torch import settings as ts
    from bluesky_tpu.plugins import opensky as jos
    from bluesky_tpu_torch.plugins import opensky as tos
    monkeypatch.setattr(time, "sleep", lambda s: None)
    monkeypatch.setattr(js, "log_path", str(tmp_path / "jax"))
    monkeypatch.setattr(ts, "log_path", str(tmp_path / "port"))

    def offline(*a, **k):
        raise urllib.error.URLError("offline")
    for mod in (jos, tos):
        monkeypatch.setattr(mod.urllib.request, "urlopen", offline)


def both(pair, *lines):
    """The same lines into both sims; the port's echo must be JAX's."""
    jsim, tsim = pair
    je, te = sim_do(jsim, *lines), sim_do(tsim, *lines)
    assert te == je, lines
    return te


def fresh(pair, *plugins):
    """Reset both sims with no plugin but ``plugins`` loaded."""
    for sim in pair:
        for name in list(sim.plugins.active):
            sim.plugins.remove(name)
    both(pair, "RESET", *(f"PLUGINS LOAD {p}" for p in plugins))
    for sim in pair:
        sim.scr.echobuf.clear()


def run_both(pair, until, step=1.0):
    for sim in pair:
        sim.op()
        sim.fastforward()
        t = sim.simt
        while t < until - 1e-9:
            t = min(until, t + step)
            sim.run(until_simt=t)


def ids(sim):
    return [i for i in sim.traf.ids if i is not None]


def log_rows(sim, name):
    """The data rows of ``name``'s log file (stopped first), as lists."""
    lg = sim.datalog.getlogger(name)
    path = lg.file.name
    lg.stop()
    with open(path) as f:
        return [[v.strip() for v in line.split(",")] for line in f
                if not line.startswith("#")]


def assert_rows_close(jrows, trows):
    assert len(trows) == len(jrows) > 0
    for jr, tr in zip(jrows, trows):
        assert len(jr) == len(tr)
        for a, b in zip(jr, tr):
            try:
                x, y = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            assert abs(x - y) <= 1e-9 * max(1.0, abs(x)), (a, b, jr)


# ------------------------------------------------------------- discovery
def test_discovery_matches_jax(pair):
    jsim, tsim = pair
    assert sorted(tsim.plugins.descriptions) \
        == sorted(jsim.plugins.descriptions)
    assert len(tsim.plugins.descriptions) == 11
    for name, jd in jsim.plugins.descriptions.items():
        td = tsim.plugins.descriptions[name]
        assert (td.module_name, td.plugin_name, td.plugin_type,
                td.plugin_stack) == (jd.module_name, jd.plugin_name,
                                     jd.plugin_type, jd.plugin_stack)
        assert os.path.dirname(td.fname) == TPATH


def test_ast_check(tmp_path):
    p = tcheck(os.path.join(TPATH, "area.py"))
    assert (p.plugin_name, p.plugin_type) == ("AREA", "sim")
    assert ("AREA", "Define experiment area (area of interest)") \
        in p.plugin_stack
    want = jcheck(os.path.join(JPATH, "area.py"))
    assert p.plugin_stack == want.plugin_stack
    f = tmp_path / "notaplugin.py"
    f.write_text("x = 1\n")
    assert tcheck(str(f)) is None
    # reading the name must not import the file
    f = tmp_path / "boom.py"
    f.write_text("raise SystemExit('imported')\n"
                 "def init_plugin(sim):\n"
                 "    config = {'plugin_name': 'BOOM', 'plugin_type': 'sim'}\n"
                 "    return config, {}\n")
    assert tcheck(str(f)).plugin_name == "BOOM"


def test_external_plugin_loads_as_a_submodule(tmp_path, monkeypatch):
    """A plugin on ``settings.plugin_path`` imports the framework
    relatively, and its commands come and go with it."""
    from bluesky_tpu_torch import settings as ts
    from bluesky_tpu_torch.simulation.sim import Simulation
    (tmp_path / "myplug.py").write_text(
        '"""A plugin outside the package."""\n'
        "from ..ops import aero\n\n\n"
        "def init_plugin(sim):\n"
        "    config = {'plugin_name': 'MYPLUG', 'plugin_type': 'sim'}\n"
        "    cmds = {'KTS': ['KTS', '', lambda: (True, str(aero.kts)),\n"
        "                    'one knot in m/s']}\n"
        "    return config, cmds\n")
    monkeypatch.setattr(ts, "plugin_path", str(tmp_path))
    sim = Simulation(nmax=16, device="cpu")
    assert "MYPLUG" in sim.plugins.descriptions
    assert sim_do(sim, "PLUGINS LOAD MYPLUG", "KTS") \
        == ["Successfully loaded plugin MYPLUG", "0.514444"]
    mod = sim.plugins.active["MYPLUG"]
    assert mod.__name__ == "bluesky_tpu_torch.plugins.myplug"
    assert sim_do(sim, "PLUGINS REMOVE MYPLUG") == ["Removed plugin MYPLUG"]
    assert "KTS" not in sim.stack.cmddict


def test_plugins_command_matches_jax(pair):
    jsim, tsim = pair
    fresh(pair)
    assert "AREA" not in tsim.stack.cmddict
    for line in ("PLUGINS LIST", "PLUGINS LOAD AREA", "PLUGINS",
                 "PLUGINS LOAD AREA", "PLUGIN LOAD NOSUCH",
                 "PLUGINS REMOVE AREA", "PLUGINS REMOVE AREA", "EXAMPLE",
                 "PLUGINS LIST", "PLUGINS UNLOAD EXAMPLE"):
        echo = both(pair, line)
        assert sorted(tsim.stack.cmddict) == sorted(jsim.stack.cmddict)
        if line == "PLUGINS LOAD AREA" and "already" not in echo[0]:
            assert {"AREA", "TAXI"} <= set(tsim.stack.cmddict)
    assert "already" in " ".join(both(pair, "PLUGINS LOAD SECTORCOUNT",
                                      "PLUGINS LOAD SECTORCOUNT"))
    assert "AREA" not in tsim.stack.cmddict
    assert "SECTORCOUNT" in tsim.stack.cmddict
    fresh(pair)
    assert "SECTORCOUNT" not in tsim.stack.cmddict


# --------------------------------------------------------------- plugins
def test_area_matches_jax(pair):
    """Three aircraft leave a small box at different times, one stays:
    the same deletions and FLSTLOG rows."""
    jsim, tsim = pair
    fresh(pair, "AREA")
    both(pair, "BOX EXPBOX 51.85 3.85 52.15 4.12",
         "CRE KL1 B744 52 4 90 FL200 250", "CRE KL2 A320 52.1 4.1 0 FL150 300",
         "CRE KL3 B744 51.9 3.9 225 FL100 200",
         "CRE KL4 B744 52.0 3.9 90 FL300 150",
         "AREA EXPBOX", "AREA")
    run_both(pair, 60.0)
    assert ids(tsim) == ids(jsim) == ["KL4"]
    assert_rows_close(log_rows(jsim, "FLSTLOG"), log_rows(tsim, "FLSTLOG"))
    both(pair, "TAXI OFF 1000", "AREA OFF", "AREA")


def test_trafgen_matches_jax(pair):
    """A source, a drain and a gain of 0: the same callsigns, counts and
    positions.  ASAS is off: aircraft spawned at one point are exactly
    co-located pairs, MVP's knife edge (ROADMAP §C)."""
    jsim, tsim = pair
    for setup, until in (
            (("TRAFGEN CIRCLE 52 4 100", "TRAFGEN SRC SEGM90 FLOW 3600"),
             20.0),
            (("TRAFGEN CIRCLE 52 4 100", "TRAFGEN DRN SEGM270 ORIG SEGM90",
              "TRAFGEN DRN SEGM270 FLOW 1800"), 20.0),
            (("TRAFGEN CIRCLE 52 4 100", "TRAFGEN SRC SEGM0 FLOW 3600",
              "TRAFGEN GAIN 0"), 10.0)):
        fresh(pair, "TRAFGEN")
        both(pair, "ASAS OFF", *setup)
        run_both(pair, until)
        assert ids(tsim) == ids(jsim)
        assert len(ids(tsim)) >= (1 if "GAIN 0" not in setup[-1] else 0)
        j = jax_tree_to_numpy(jsim.traf.state)
        t = state_to_numpy(tsim.traf.state)
        np.testing.assert_array_equal(t["ac.active"], j["ac.active"])
        for k in ("ac.lat", "ac.lon", "ac.alt", "ac.hdg"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-9,
                                       err_msg=k)
    assert not ids(tsim)
    both(pair, "TRAFGEN")


def test_sectorcount_matches_jax(pair):
    jsim, tsim = pair
    fresh(pair, "SECTORCOUNT")
    both(pair, "BOX S1 51.9 3.9 52.1 4.2", "SECTORCOUNT LIST",
         "SECTORCOUNT ADD S1", "SECTORCOUNT ADD NOSUCH",
         "CRE KL1 B744 52 4 90 FL200 250", "CRE KL2 B744 52 3.7 90 FL200 300",
         "CRE KL3 B744 51.5 4 0 FL200 250")
    run_both(pair, 30.0)
    both(pair, "SECTORCOUNT LIST")
    assert_rows_close(log_rows(jsim, "OCCUPANCYLOG"),
                      log_rows(tsim, "OCCUPANCYLOG"))
    both(pair, "SECTORCOUNT REMOVE S1", "SECTORCOUNT LIST")


def test_geovector_matches_jax(pair):
    jsim, tsim = pair
    fresh(pair, "GEOVECTOR")
    both(pair, "BOX GV 51 3 53 5", "BOX FAR 10 -10 20 0",
         "CRE IN1 B744 52 4 90 FL200 150", "CRE IN2 B744 52.5 4.5 10 FL100 350",
         "CRE OUT B744 55 8 90 FL200 150",
         "GEOVECTOR GV 250 300 0 45 -5 5", "GEOVECTOR FAR 300 350",
         "GEOVECTOR GV", "GEOVECTOR NOSUCH 1 2")
    before = state_to_numpy(tsim.traf.state)["ac.selspd"].copy()
    run_both(pair, 5.0)
    j = jax_tree_to_numpy(jsim.traf.state)
    t = state_to_numpy(tsim.traf.state)
    for k in ("ac.selspd", "ac.selvs", "ac.selalt", "ap.trk", "ac.lat",
              "ac.lon", "ac.tas"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    i_in, i_out = tsim.traf.id2idx("IN1"), tsim.traf.id2idx("OUT")
    assert t["ac.selspd"][i_in] > before[i_in]
    assert t["ac.selspd"][i_out] == before[i_out]
    both(pair, "DELGEOVECTOR GV", "DELGEOVECTOR GV", "GEOVECTOR GV")


def test_ilsgate_and_feeds_match_jax(pair):
    jsim, tsim = pair
    fresh(pair, "ILSGATE", "OPENSKY", "ADSBFEED", "WINDGFS", "EXAMPLE")
    both(pair, "ILSGATE EHAM18R 52.33 4.71 184", "ILSGATE EHAM/RW18R",
         "ILSGATE EHAM18R")
    np.testing.assert_allclose(
        tsim.areas.areas["ILSEHAM18R"].coordinates,
        jsim.areas.areas["ILSEHAM18R"].coordinates, rtol=1e-12)
    both(pair, "OPENSKY", "OPENSKY ON", "CRE KL1 B744 52 4 90 FL200 250")
    run_both(pair, 8.0)
    both(pair, "OPENSKY OFF", "ADSBFEED ON", "ADSBFEED", "WINDGFS",
         "WINDGFS 50 0 52 4", "MYFUN ON")


def test_stackcheck_raises_nothing(tmp_path):
    """The fuzz of every registered command (the plugins' among them)
    raises nothing in the port."""
    from bluesky_tpu_torch.simulation.sim import Simulation
    sim = Simulation(nmax=32, dtype=torch.float64, device="cpu")
    for name in sorted(sim.plugins.descriptions):
        assert sim_do(sim, f"PLUGINS LOAD {name}") \
            == [f"Successfully loaded plugin {name}"]
    out = "\n".join(sim_do(sim, "STACKCHECK"))
    assert "commands fired, 0 failed" in out, out


# ----------------------------------------------------- the sim's hooks
def test_plugin_edges_are_synchronous(pair):
    """EXAMPLE (1 s) and TRAFGEN (0.1 s: 2-step chunks): the same update
    counts as JAX's, every due edge synchronous with reason ``plugin``;
    unloaded, the chunks pipeline and no edge gives that reason."""
    jsim, tsim = pair
    fresh(pair, "EXAMPLE")
    both(pair, "CRE KL1 B744 52 4 90 FL200 250")
    reasons = tsim.pipe_stats["sync_reasons"]
    p0 = reasons.get("plugin", 0)
    run_both(pair, 5.0, step=5.0)
    both(pair, "MYFUN ON")
    assert reasons.get("plugin", 0) - p0 == 5
    both(pair, "PLUGINS LOAD TRAFGEN")
    assert tsim.plugins.min_dt() == pytest.approx(0.1)
    n0 = tsim._step_count
    tsim.step()
    assert tsim._step_count - n0 == 2
    fresh(pair)
    both(pair, "CRE KL1 B744 52 4 90 FL200 250")
    p0, piped = reasons.get("plugin", 0), tsim.pipe_stats["pipelined_chunks"]
    run_both(pair, 5.0, step=5.0)
    assert reasons.get("plugin", 0) == p0
    assert tsim.pipe_stats["pipelined_chunks"] > piped


# -------------------------------------------------------------- ENSEMBLE
def _ensemble_states(nrep, nmax=64, n=40):
    """The same sparse scene in both packages (sort refreshed), stacked
    ``nrep`` times with the same numpy displacement per replica."""
    from bluesky_tpu.core import asas as jasas
    from bluesky_tpu.core.step import SimConfig as JCfg
    from bluesky_tpu.parallel import sharding as jsh
    from bluesky_tpu_torch.core import asas as tasas
    from bluesky_tpu_torch.core.state import world_slice
    from bluesky_tpu_torch.core.step import SimConfig as TCfg
    from bluesky_tpu_torch.parallel import sharding as tsh
    jst, tst = torch_parity.build_pair(nmax, n, "cluster", seed=4,
                                       dtype="float64")
    jcfg, tcfg = (C(cd_backend="sparse", cd_block=64) for C in (JCfg, TCfg))
    jst = jasas.refresh_spatial_sort(jst, jcfg.asas, block=64,
                                     impl="sparse")
    tst = tasas.refresh_spatial_sort(tst, tcfg.asas, block=64,
                                     impl="sparse")
    rng = np.random.default_rng(11)
    dlat = rng.normal(0.0, 0.004, (nrep, nmax))
    dlon = rng.normal(0.0, 0.006, (nrep, nmax))
    jreps, treps = [], []
    for r in range(nrep):
        jreps.append(jst.replace(ac=jst.ac.replace(
            lat=jnp.where(jst.ac.active, jst.ac.lat + dlat[r], jst.ac.lat),
            lon=jnp.where(jst.ac.active, jst.ac.lon + dlon[r],
                          jst.ac.lon))))
        # a copy of the port's state (stacking copies)
        one = world_slice(tsh.stack_replicas([tst]), 0)
        act = one.ac.active
        one.ac.lat.copy_(torch.where(act, one.ac.lat
                                     + torch.from_numpy(dlat[r]),
                                     one.ac.lat))
        one.ac.lon.copy_(torch.where(act, one.ac.lon
                                     + torch.from_numpy(dlon[r]),
                                     one.ac.lon))
        treps.append(one)
    return (jsh.stack_replicas(jreps), jcfg,
            tsh.stack_replicas(treps), tcfg)


def test_ensemble_stepping_matches_jax(pair):
    """(a) 4 replicas, one CD-interval chunk: the port's ``Ensemble.
    step`` against JAX's ``ensemble_step_fn`` on the same stacked
    states.  Flags and counts equal, lat/lon within 1e-9, the rest at
    ``torch_parity``'s bounds for the float32 CD kernels."""
    from bluesky_tpu.parallel import sharding as jsh
    from bluesky_tpu_torch.plugins.ensemble import Ensemble
    jstates, jcfg, tstates, tcfg = _ensemble_states(4)
    jrun = lambda s, k: jsh.ensemble_step_fn(
        jsh.make_ensemble_mesh(1), jcfg, nsteps=k)(s)
    jout = jrun(jstates, 20)
    ens = Ensemble(pair[1])
    tout, (peak_conf, peak_los, mean_conf, mean_los) = ens.step(
        tstates, tcfg, 1.0)
    assert [k[3] for k in ens._cache] == [20]
    j = jax_tree_to_numpy(jout)
    t = state_to_numpy(tout)
    for k in j:
        x, y = np.asarray(j[k]), np.asarray(t[k])
        if k == "rng":
            continue
        if k in ("asas.partners", "asas.partners_s"):
            assert [partner_sets(a) for a in x] \
                == [partner_sets(b) for b in y], k
        elif x.dtype.kind in "biu":
            np.testing.assert_array_equal(y, x, err_msg=k)
        elif k in ("ac.lat", "ac.lon"):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-9, err_msg=k)
        elif k.endswith(".alt"):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-2, err_msg=k)
        else:
            np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-3,
                                       err_msg=k)
    nconf = np.asarray(j["asas.nconf_cur"]) / 2.0
    assert nconf.min() > 0
    np.testing.assert_array_equal(peak_conf, nconf)
    np.testing.assert_array_equal(mean_conf, nconf)
    np.testing.assert_array_equal(peak_los,
                                  np.asarray(j["asas.nlos_cur"]) / 2.0)


def _scripted(monkeypatch, nreps, counts_of):
    """Patch both packages' ``ensemble_step_fn`` with a runner whose
    chunk k returns the counts ``counts_of(k)``; both see 8 devices."""
    from types import SimpleNamespace
    from bluesky_tpu.parallel import sharding as jsh
    from bluesky_tpu_torch.parallel import sharding as tsh
    monkeypatch.setattr(tsh, "default_devices", lambda device=None:
                        [CPU] * 8)
    assert len(jax.devices()) == 8

    def fake(tensor):
        def make(mesh, cfg, nsteps=1):
            def run(states):
                k = getattr(states, "k", -1) + 1
                nc, nl = counts_of(k)
                return SimpleNamespace(k=k, asas=SimpleNamespace(
                    nconf_cur=tensor(nc), nlos_cur=tensor(nl)))
            return run
        return make
    monkeypatch.setattr(jsh, "ensemble_step_fn", fake(jnp.asarray))
    monkeypatch.setattr(tsh, "ensemble_step_fn", fake(torch.as_tensor))


def test_ensemble_statistics_and_reply_match_jax(pair, monkeypatch):
    """(b) The same scripted per-replica conflict and LoS counts in both:
    the same reply and statistics; the guards answer the same."""
    jsim, tsim = pair
    fresh(pair, "ENSEMBLE")
    both(pair, "ENSEMBLE 4 10")
    rng = np.random.default_rng(2)
    script = rng.integers(0, 9, (20, 2, 5)) * 2
    _scripted(monkeypatch, 5, lambda k: (script[k, 0], script[k, 1]))
    both(pair, "CRE E1 B744 52.0 3.8 090 FL200 250",
         "CRE E2 B744 52.0 4.2 270 FL200 250", "ENSEMBLE 1 10")
    echo = both(pair, "ENSEMBLE 5 10.5 300")
    assert "conflicts" in echo[0] and "on 5 device(s)" in echo[0]
    jens = jsim.stack.cmddict["ENSEMBLE"][2].__self__
    tens = tsim.stack.cmddict["ENSEMBLE"][2].__self__
    assert tens.last == jens.last
    assert {k[3] for k in tens._cache} == {k[3] for k in jens._cache} \
        == {20, 10}
    fresh(pair)


def test_ensemble_jitter_statistics():
    """(c) 64 replicas of a 256-slot scene (240 aircraft), 500 m."""
    from bluesky_tpu_torch.core.traffic import Traffic
    from bluesky_tpu_torch.plugins.ensemble import Ensemble
    rng = np.random.default_rng(7)
    n, nmax, nrep, spread = 256, 256, 64, 500.0
    traf = Traffic(nmax=nmax, dtype=torch.float64, device="cpu")
    traf.create(n, "B744", rng.uniform(3000.0, 11000.0, n),
                rng.uniform(130.0, 240.0, n), None,
                rng.uniform(-70.0, 80.0, n), rng.uniform(-20.0, 30.0, n),
                rng.uniform(0.0, 360.0, n))
    traf.flush()
    traf.delete(np.arange(0, nmax, 16))
    base = traf.state
    before = {k: v.copy() for k, v in state_to_numpy(base).items()
              if k.startswith("ac.")}
    reps = Ensemble.jitter(base, nrep, spread, 1)
    after = state_to_numpy(base)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    act = before["ac.active"]
    assert act.sum() == 240
    got = state_to_numpy(reps)
    d = {k: got[f"ac.{k}"] - before[f"ac.{k}"][None]
         for k in ("lat", "lon", "tas", "gs")}
    for k in d:
        assert (d[k][:, ~act] == 0).all(), k
        assert np.array_equal(got[f"ac.{k}"][:, ~act],
                              np.broadcast_to(before[f"ac.{k}"][~act],
                                              (nrep, (~act).sum()))), k
    mlat = spread / 111_000.0
    scale = np.maximum(np.cos(np.radians(before["ac.lat"][act])), 0.2)
    samples = dict(lat=d["lat"][:, act] / mlat,
                   lon=d["lon"][:, act] * scale / mlat,
                   tas=d["tas"][:, act] / 0.5, gs=d["gs"][:, act] / 0.5)
    for k, z in samples.items():
        assert abs(z.mean()) < 4.0 / np.sqrt(z.size), k
        assert abs(z.std() - 1.0) < 0.05, k
    # every replica differs, its rng is fresh, another run draws anew
    assert len({float(got["ac.lat"][r, 1]) for r in range(nrep)}) == nrep
    assert len(set(reps.rng.tolist()) | {int(base.rng)}) == nrep + 1
    again = state_to_numpy(Ensemble.jitter(base, nrep, spread, 1))
    assert np.array_equal(again["ac.lat"], got["ac.lat"])
    other = state_to_numpy(Ensemble.jitter(base, nrep, spread, 2))
    assert not np.array_equal(other["ac.lat"][:, act],
                              got["ac.lat"][:, act])
