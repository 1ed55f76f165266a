"""The port's ``Simulation`` against the JAX package's, on the CPU.

Every case types the same command lines into the JAX ``Simulation`` and
the port's ``Simulation(device="cpu")`` (32 slots, float64, wall-clock
pacing off) and holds the results against each other with
``torch_parity.assert_sims_equal``: echo text, callsigns, routes and
configuration equal; ints, bools (flags, counts) and partner sets
equal; floats within 1e-9 (the resolver commands within 1e-7).

* SUPER 8 with ASAS ON for 10 s under each resolver on the dense and
  tiled backends (the sparse and pallas backends, which run the float32
  kernels, are ``tests/test_torch_sim_kernels.py``).
* The pipelined loop against ``CHUNKSTEPS PIPELINE OFF`` in the port:
  bit-equal.
* The integrity guard: a NaN written into one live slot, then the
  quarantine, rollback and halt policies, each against JAX (the trip
  records, the deleted slots, the restored or frozen state).
* ATALT/ATSPD conditionals fire at the same sim time.
* ``ChunkEdge.acdata_arrays`` equals JAX's.
* Every bundled ``scenario/*.scn`` runs clean (the markers of
  ``tests/test_bundled_scenarios.py``) and ends with JAX's callsigns and
  state; the noise demo only with JAX's callsigns (turbulence and ADS-B
  noise draw from torch's generator, not JAX's threefry: noise parity
  is by statistics, ROADMAP A10); the two scenarios of exactly
  co-altitude mirror pairs (``KNIFE_EDGE``) with JAX's full state at
  1 s and its flags, counts and pair memory at 4 s.
"""
import glob
import os

import numpy as np
import pytest

from bluesky_tpu_torch.core.state import state_to_numpy

from torch_parity import (SIM_CMD_RTOL, SIM_RTOL, SIM_ATOL,
                          assert_sims_equal, jax_tree_to_numpy, no_pacing,
                          sim_do, sim_pair)

SUPER8 = ("SYN SUPER 8", "ASAS ON")
SCN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenario")
SCENARIOS = sorted(glob.glob(os.path.join(SCN_DIR, "*.scn")))
BAD_MARKERS = ("Unknown command", "Syntax", "not found", "error")


@pytest.fixture(autouse=True)
def _no_pacing(monkeypatch):
    no_pacing(monkeypatch)


def both(lines, until, **kw):
    """The pair after ``lines`` and ``until`` one-second runs (the
    interactive 20-step chunk); with their echo."""
    jsim, tsim = sim_pair(**kw)
    echo = []
    for sim in (jsim, tsim):
        out = sim_do(sim, *lines)
        for t in range(1, until + 1):
            sim.run(until_simt=float(t))
        echo.append(out + sim.scr.echobuf)
        sim.scr.echobuf.clear()
    return jsim, tsim, echo


@pytest.mark.parametrize("cd", ["DENSE", "TILED"])
@pytest.mark.parametrize("reso", ["MVP", "EBY", "SWARM", "SSD"])
def test_super8(reso, cd):
    jsim, tsim, (je, te) = both(
        SUPER8 + (f"RESO {reso}", f"CDMETHOD {cd}"), 10)
    assert_sims_equal(jsim, tsim, je, te)
    assert tsim.traf.ntraf == 8
    assert int(tsim.traf.state.asas.nconf_cur) > 0 or reso != "MVP"


def test_pipeline_off_is_bit_equal():
    """The pipelined loop and the synchronous one step the same states."""
    runs = []
    for pipe in ("ON", "OFF"):
        _, tsim = sim_pair()
        echo = sim_do(tsim, *SUPER8, f"CHUNKSTEPS PIPELINE {pipe}")
        tsim.run(until_simt=6.0)
        ps = tsim.pipe_stats
        assert (ps["pipelined_chunks"] > 0) == (pipe == "ON")
        assert (ps["sync_chunks"] > 0) == (pipe == "OFF")
        runs.append((echo[1:], state_to_numpy(tsim.traf.state)))
    (e1, a), (e2, b) = runs
    assert e1 == e2
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _poison(jsim, tsim, i):
    """A NaN latitude in slot ``i`` of both states."""
    js = jsim.traf.state
    jsim.traf.state = js.replace(ac=js.ac.replace(
        lat=js.ac.lat.at[i].set(np.nan)))
    tsim.traf.state.ac.lat[i] = float("nan")


@pytest.mark.parametrize("policy", ["quarantine", "rollback", "halt"])
def test_guard(policy):
    jsim, tsim = sim_pair()
    echo = []
    for sim in (jsim, tsim):
        assert sim.guard.set_policy(policy)
        sim.snap_ring.dt = 1.0           # a restore point every second
        sim_do(sim, *SUPER8)
        sim.run(until_simt=3.0)
    acid = tsim.traf.ids[2]
    assert jsim.traf.ids[2] == acid
    _poison(jsim, tsim, 2)
    for sim in (jsim, tsim):
        sim.run(until_simt=6.0)
        echo.append(list(sim.scr.echobuf))
        sim.scr.echobuf.clear()
    trip = lambda t: (t["simt"], t["bad_step"], t["chunk"], t["ids"],
                      t["action"], t.get("deferred"))
    assert [trip(t) for t in tsim.guard.trips] \
        == [trip(t) for t in jsim.guard.trips]
    assert len(tsim.guard.trips) == 1
    assert tsim.guard.trips[0]["ids"] == [acid]
    want = {"quarantine": "quarantine", "halt": "halt",
            "rollback": "rollback+quarantine"}[policy]
    assert tsim.guard.trips[0]["action"] == want
    assert (acid in tsim.traf.ids) == (policy == "halt")
    assert_sims_equal(jsim, tsim, echo[0], echo[1])


def test_conditionals_fire_at_the_same_time():
    """ATALT and ATSPD fire at the same chunk edge in both packages."""
    lines = ("CRE CND1 B744 52.0 4.0 090 FL100 220",
             "CND1 ATALT FL105 ECHO passed FL105",
             "ALT CND1 FL120", "CND1 ATSPD 230 ECHO through 230 kts",
             "SPD CND1 250")
    jsim, tsim = sim_pair()
    fired = []
    for sim in (jsim, tsim):
        sim_do(sim, *lines)
        log = []
        for t in range(1, 41):
            sim.run(until_simt=float(t))
            log += [(sim.simt, e) for e in sim.scr.echobuf]
            sim.scr.echobuf.clear()
        fired.append(log)
    assert fired[1] == fired[0]
    assert [e for _, e in fired[1]] == ["through 230 kts", "passed FL105"] \
        or [e for _, e in fired[1]] == ["passed FL105", "through 230 kts"]
    assert tsim.cond.ncond == 0
    assert_sims_equal(jsim, tsim, [], [])


def test_acdata_arrays():
    jsim, tsim, (je, te) = both(SUPER8, 5)
    jidx, jdata = jsim._last_edge.acdata_arrays()
    tidx, tdata = tsim._last_edge.acdata_arrays()
    np.testing.assert_array_equal(tidx, jidx)
    assert sorted(tdata) == sorted(jdata)
    for k, want in jdata.items():
        got = tdata[k]
        assert got.dtype == want.dtype, k
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            rtol = SIM_CMD_RTOL if k in ("asasn", "asase", "tcpamax") \
                else SIM_RTOL
            np.testing.assert_allclose(got, want, rtol=rtol, atol=SIM_ATOL,
                                       err_msg=k)


#: scenarios of exactly co-altitude mirror pairs: from the ASAS interval
#: at t=1 s MVP's vertical branch (``|vrel_v| > 0``) turns on JAX's last
#: bit (ROADMAP §C), so past 1 s they are held to the flags and counts
KNIFE_EDGE = ("demo-head-on.scn", "demo-areas-metrics.scn")


@pytest.mark.parametrize(
    "path", SCENARIOS, ids=[os.path.basename(p) for p in SCENARIOS])
def test_bundled_scenario(path, tmp_path, monkeypatch):
    """The scenario at 1 s and at 4 s: clean, JAX's callsigns and state
    (the noise demo: JAX's callsigns; ``KNIFE_EDGE`` past 1 s: JAX's
    callsigns, conflict flags, counts and pair memory)."""
    from bluesky_tpu.utils import datalog as jdatalog
    from bluesky_tpu_torch.utils import datalog as tdatalog
    monkeypatch.chdir(tmp_path)          # logs land in tmp
    jsim, tsim = sim_pair(nmax=64)
    name = os.path.basename(path)
    try:
        for until in (1.0, 4.0):
            echo = []
            for sim in (jsim, tsim):
                if until == 1.0:
                    ok, msg = sim.stack.ic(path)
                    assert ok, msg
                sim.run(until_simt=until)
                echo.append(list(sim.scr.echobuf))
            text = "\n".join(echo[1]).lower()
            for marker in BAD_MARKERS:
                assert marker.lower() not in text, (marker, echo[1])
            assert tsim.traf.ids == jsim.traf.ids
            if "noise" in name:
                assert tsim.cfg.noise.turb_active and echo[1] == echo[0]
            elif until == 4.0 and name in KNIFE_EDGE:
                assert echo[1] == echo[0]
                j = jax_tree_to_numpy(jsim.traf.state)
                t = state_to_numpy(tsim.traf.state)
                for k in ("asas.inconf", "asas.active", "asas.resopairs",
                          "asas.nconf_cur", "asas.nlos_cur", "ac.active"):
                    assert np.array_equal(t[k], j[k]), k
            else:
                assert_sims_equal(jsim, tsim, echo[0], echo[1])
    finally:
        jdatalog.reset()
        tdatalog.reset()
    if "mc-batch" not in name:
        assert tsim.traf.ntraf > 0


#: two head-on pairs with LNAV-direct routes to each other's start (the
#: scenario of JAX ``tests/test_diff.py``'s OPT piece, legs of ±0.2 deg:
#: the pairs meet at ~90 s)
OPT_LINES = tuple(line for k in range(2) for line in (
    f"CRE OA{k:02d} B744 {48.0 + 0.8 * k} 3.8 90 FL200 250",
    f"CRE OB{k:02d} B744 {48.0 + 0.8 * k} 4.2 270 FL200 250",
    f"ADDWPT OA{k:02d} {48.0 + 0.8 * k},4.2",
    f"ADDWPT OB{k:02d} {48.0 + 0.8 * k},3.8"))
_NUM = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?"


def _same_echo(jecho, techo):
    """Echo lines equal but for the last printed digit of a number."""
    import re
    assert len(techo) == len(jecho)
    for j, t in zip(jecho, techo):
        assert re.sub(_NUM, "#", t) == re.sub(_NUM, "#", j), (t, j)
        for a, b in zip(re.findall(_NUM, t), re.findall(_NUM, j)):
            assert float(a) == pytest.approx(float(b), rel=1e-3, abs=1e-3), \
                (t, j)


def test_opt_and_grad_commands(monkeypatch):
    """GRAD and OPT typed into both simulations on the same scene answer
    alike (the objective, the gradient norm, the guard word; the descent
    from JAX's initial draw and its hard-metric verification, here at
    0.25 s), and OPT leaves the simulation held."""
    import jax
    import jax.numpy as jnp
    import torch
    import bluesky_tpu.settings as jset
    import bluesky_tpu_torch.settings as tset
    from bluesky_tpu_torch.diff import optimize as topt
    for s in (jset, tset):
        monkeypatch.setattr(s, "opt_verify_dt", 0.25)

    def jax_draw(state, restarts=1, seed=0, init_noise=0.1):
        # JAX optimize's PRNGKey draw, which torch cannot reproduce
        n = state.ac.lat.shape[-1]
        lat0 = init_noise * jax.random.normal(jax.random.PRNGKey(seed),
                                              (n,), jnp.float64)
        return topt.OffsetParams(torch.from_numpy(np.array(lat0)),
                                 torch.zeros(n, dtype=torch.float64))
    monkeypatch.setattr(topt, "init_offsets", jax_draw)
    jsim, tsim = sim_pair()
    for sim in (jsim, tsim):
        sim_do(sim, *OPT_LINES)
    for line in ("GRAD 100", "OPT 100,3,0.5"):
        jecho, techo = sim_do(jsim, line), sim_do(tsim, line)
        _same_echo(jecho, techo)
        assert techo and techo[0].startswith(line.split()[0] + ":")
        assert not any("ROADMAP" in e or "TRIP" in e for e in techo)
    assert "hard LoS 4 -> " in techo[0]
    assert tsim.state_flag == jsim.state_flag
    assert tsim.traf.ntraf == 4


def test_optimize_trajectories_guard_trip():
    """A NaN latitude trips the forward guard word in the rollout: the
    descent halts after its first iteration at the last finite offsets,
    and the trip is logged with the action ``opt_halt``, as in JAX."""
    jsim, tsim = sim_pair(nmax=4)
    res = []
    for sim in (jsim, tsim):
        sim_do(sim, "CRE A1 B744 48 3.5 90 6000 200",
               "CRE A2 B744 48 4.5 270 6000 200")
    _poison(jsim, tsim, 0)
    for sim in (jsim, tsim):
        res.append(sim.optimize_trajectories(tend=20.0, iters=2, simdt=1.0,
                                             chunk=10, verify_simdt=1.0))
    (jr, tr) = res
    assert tr.bad == jr.bad >= 0
    assert tr.iters == jr.iters == 1
    assert [t["action"] for t in tsim.guard.trips] == ["opt_halt"]
    assert [(t["bad_step"], t["action"]) for t in tsim.guard.trips] \
        == [(t["bad_step"], t["action"]) for t in jsim.guard.trips]
    assert np.all(np.isfinite(tr.lateral_m))
    assert np.all(np.isfinite(tr.tshift_s))
    assert any("integrity-guard trip" in e for e in tsim.scr.echobuf)
