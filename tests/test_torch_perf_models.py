"""The port's BS and BADA performance models against the JAX package's,
on the CPU.

No BS or BADA data ships, so both packages read the synthetic files of
``bluesky_tpu_torch/models/synthetic.py`` (BADA's OPF/APF lines are the
JAX package's own generator of ``tests/test_perf_models.py``), written
into ``tmp_path``:

* ``FixedWidthParser``, ``parse_opf``, ``parse_apf``, ``load_bada_dir``
  (with ``SYNONYM.NEW``), ``get_coefficients`` and ``bada_to_generic``
  give equal dicts (floats within rel 1e-12); so do ``load_engines``,
  ``load_aircraft_file``, ``load_bs_dir`` and ``bs_to_generic`` on a
  twin jet, a four-engine jet and a turboprop; a missing directory is
  ``{}`` in both;
* under ``settings.performance_model`` "bs", "legacy" and "bada" (each
  package's own ``settings`` patched), ``Traffic.create`` gives every
  ``PerfArrays`` column equal at float64, for the data's types, a
  built-in type and an unknown one;
* 20 sim-s of a BADA-configured ``Simulation`` pair (CDMETHOD SPARSE,
  MVP, noise off) in float64: flags and counts equal, every other field
  at ``torch_parity``'s bounds for a run through the float32 CD kernels;
* ``ops/perf_legacy`` (``phases``, ``esf``, ``calclimits``) and
  ``ops/perf_bada`` (``max_climb_thrust``, ``thrust``,
  ``reduced_climb_power``, ``fuelflow``) at float64 on 2,048 rows drawn
  as ``tests/test_perf_models.py::_rand_state`` draws them, every engine
  type and every phase present: floats within rel 1e-12, phase codes
  and flags equal.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)
from torch_parity import (assert_sim_states, assert_trees_equal,
                          jax_tree_to_numpy, no_pacing, sim_do, sim_pair)
from bluesky_tpu.models import coeff_bada as jbada, coeff_bs as jbs
from bluesky_tpu.models import fwparser as jfw
from bluesky_tpu.ops import aero, perf_bada as jpb, perf_legacy as jpl
from bluesky_tpu_torch.models import coeff_bada as tbada, coeff_bs as tbs
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.models import fwparser as tfw, synthetic
from bluesky_tpu_torch.ops import perf_bada as tpb, perf_legacy as tpl

N = 2048


def assert_same(a, b, path="", rtol=1e-12):
    """Equal nested dicts/lists, floats within ``rtol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}", rtol)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", rtol)
    elif isinstance(a, float):
        assert isinstance(b, float), path
        assert b == pytest.approx(a, rel=rtol, abs=0.0), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.fixture(scope="module")
def perf_dir(tmp_path_factory):
    return synthetic.write_perf_tree(str(tmp_path_factory.mktemp("perf")))


# ------------------------------------------------------------------ BADA
def test_fwparser_matches_jax(perf_dir):
    d = os.path.join(perf_dir, "BADA")
    for fname, spec in (("SYNONYM.NEW", tbada.SYN_FORMAT),
                        ("A320__.OPF", tbada.OPF_FORMAT),
                        ("A320__.APF", tbada.APF_FORMAT)):
        f = os.path.join(d, fname)
        got = tfw.FixedWidthParser(spec).parse(f)
        assert_same(jfw.FixedWidthParser(spec).parse(f), got)
        assert got, fname
    with pytest.raises(ValueError):
        tfw.FixedWidthParser(["CD, 3Q"])
    bad = os.path.join(perf_dir, "bad.OPF")
    with open(bad, "w") as f:
        f.write("CD   notafloat\n")
    with pytest.raises(tfw.ParseError) as e:
        tfw.FixedWidthParser(["CD, 2X, 10F"]).parse(bad)
    assert e.value.lineno == 1


def test_bada_parsers_match_jax(perf_dir):
    d = os.path.join(perf_dir, "BADA")
    opf, apf = os.path.join(d, "A320__.OPF"), os.path.join(d, "A320__.APF")
    assert_same(jbada.parse_opf(opf), tbada.parse_opf(opf))
    assert_same(jbada.parse_apf(apf), tbada.parse_apf(apf))
    jsyn, jco = jbada.load_bada_dir(d)
    tsyn, tco = tbada.load_bada_dir(d)
    assert_same(jsyn, tsyn)
    assert_same(jco, tco)
    assert set(tco) == {"A320"} and tsyn["A320"]["file"] == "A320__"
    for code in ("A320", "B744"):
        jd = jbada.get_coefficients(jsyn, jco, code)
        td = tbada.get_coefficients(tsyn, tco, code)
        assert_same(jd, td)
    gen = tbada.bada_to_generic(tbada.get_coefficients(tsyn, tco, "A320"))
    assert_same(jbada.bada_to_generic(jbada.get_coefficients(
        jsyn, jco, "A320")), gen)
    assert gen["mtow"] == 77000.0 and gen["hmax"] == 38000.0 * aero.ft


def test_missing_dirs_are_empty(tmp_path):
    for mod in (jbada, tbada):
        assert mod.load_bada_dir(str(tmp_path / "none")) == ({}, {})
    for mod in (jbs, tbs):
        assert mod.load_bs_dir(str(tmp_path / "none")) == {}


# -------------------------------------------------------------------- BS
def test_bs_loaders_match_jax(perf_dir):
    d = os.path.join(perf_dir, "BS")
    assert_same(jbs.load_engines(os.path.join(d, "engines")),
                tbs.load_engines(os.path.join(d, "engines")))
    for t in synthetic.BS_TYPES:
        f = os.path.join(d, "aircraft", f"{t}.xml")
        assert_same(jbs.load_aircraft_file(f), tbs.load_aircraft_file(f))
    want, got = jbs.load_bs_dir(d), tbs.load_bs_dir(d)
    assert_same(want, got)
    assert set(got) == set(synthetic.BS_TYPES)
    # a jet and a turboprop, the first listed engine that exists
    assert got["A320"]["engine"]["name"] == "CFM56-5B4"
    assert got["AT72"]["engine"]["eng_type"] == 2
    for t in synthetic.BS_TYPES:
        assert_same(jbs.bs_to_generic(want[t]), tbs.bs_to_generic(got[t]))
    assert (tbs.D_CD0_JET, tbs.D_K_JET, tbs.D_CD0_TP, tbs.D_K_TP,
            tbs.SFC_BY_BPR_CAT) == (jbs.D_CD0_JET, jbs.D_K_JET,
                                    jbs.D_CD0_TP, jbs.D_K_TP,
                                    jbs.SFC_BY_BPR_CAT)


# ------------------------------------------------- CoeffDB and Traffic
@pytest.fixture()
def both_models(monkeypatch, perf_dir):
    """Point both packages' settings at the synthetic tree; returns a
    setter of the performance model."""
    from bluesky_tpu import settings as js
    from bluesky_tpu_torch import settings as ts
    for mod in (js, ts):
        monkeypatch.setattr(mod, "perf_path", perf_dir)

    def use(model):
        for mod in (js, ts):
            monkeypatch.setattr(mod, "performance_model", model)
    return use


TYPES = ("A320", "B744", "AT72", "E190", "XXXX")


@pytest.mark.parametrize("model", ["bs", "legacy", "bada"])
def test_perf_columns_match_jax(both_models, model):
    from bluesky_tpu.core.traffic import Traffic as JTraffic
    from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
    both_models(model)
    n = len(TYPES)
    rng = np.random.default_rng(3)
    args = (list(TYPES), rng.uniform(3000.0, 9000.0, n),
            rng.uniform(120.0, 200.0, n), None, rng.uniform(51.0, 53.0, n),
            rng.uniform(3.0, 5.0, n), rng.uniform(0.0, 360.0, n))
    jt = JTraffic(nmax=8, dtype=jnp.float64)
    tt = TTraffic(nmax=8, dtype=torch.float64, device="cpu")
    for t in (jt, tt):
        t.create(n, *args)
        t.flush()
    assert tt.coeffdb.model == model
    assert sorted(tt.coeffdb.table) == sorted(jt.coeffdb.table)
    want = {k: v for k, v in jax_tree_to_numpy(jt.state).items()
            if k.startswith("perf.")}
    got = {k: v for k, v in state_to_numpy(tt.state).items()
           if k.startswith("perf.")}
    assert len(got) > 30
    assert_trees_equal(want, got)
    tp = tt.state.perf
    # the data's own values reached the slots
    if model == "bada":
        assert float(tp.mass[0]) == 64000.0
        assert float(tp.vmaxer[0]) == pytest.approx(350.0 * aero.kts)
    else:
        assert float(tp.mass[0]) == 73500.0
        assert float(tp.sref[2]) == 61.0


def test_bada_simulation_matches_jax(both_models, monkeypatch):
    """20 sim-s of a BADA-configured Simulation under CDMETHOD SPARSE
    with MVP (noise off) in both packages, in one-second runs."""
    no_pacing(monkeypatch)
    both_models("bada")
    jsim, tsim = sim_pair(nmax=64)
    lines = ["CRE A1 A320 52.0 3.80 090 FL200 250",
             "CRE A2 A320 52.0 4.20 270 FL200 250",
             "CRE B1 B744 52.1 4.00 180 FL210 280",
             "CRE B2 A320 51.9 4.00 000 FL190 240",
             "CRE C1 XXXX 52.3 4.40 225 FL150 230",
             "ASAS ON", "RESO MVP", "CDMETHOD SPARSE"]
    je, te = sim_do(jsim, *lines), sim_do(tsim, *lines)
    assert te == je
    for t in range(1, 21):
        for sim in (jsim, tsim):
            sim.run(until_simt=float(t))
    assert tsim.simt == jsim.simt and round(tsim.simt) == 20
    assert tsim.traf.ids == jsim.traf.ids
    assert float(tsim.traf.state.perf.mass[0]) == 64000.0
    assert int(tsim.traf.state.asas.nconf_cur) > 0
    assert_sim_states(jsim, tsim, f32_cd=True)
    want = jax_tree_to_numpy(jsim.traf.state)
    got = state_to_numpy(tsim.traf.state)
    for k in ("ac.lat", "ac.lon"):
        np.testing.assert_allclose(got[k], want[k], rtol=0.0, atol=1e-9,
                                   err_msg=k)


# ---------------------------------------------- perf_legacy / perf_bada
def _rand_state(n, seed):
    """``tests/test_perf_models.py::_rand_state``."""
    rng = np.random.default_rng(seed)
    ft, kts = aero.ft, aero.kts
    alt = rng.uniform(0.0, 40000.0, n) * ft
    alt[rng.random(n) < 0.1] = 0.0                      # some on ground
    gs = rng.uniform(0.0, 260.0, n)
    delalt = rng.uniform(-3000.0, 3000.0, n) * ft
    delalt[rng.random(n) < 0.2] = 0.0
    cas = rng.uniform(50.0, 200.0, n)
    return alt, gs, delalt, cas


def _engines(rng, n):
    eng = rng.integers(0, 3, n)
    return eng == 0, eng == 1, eng == 2


def _both(jfn, tfn, args, names):
    """Run both on the same numpy ``args``; compare every output."""
    want = jfn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args))
    got = tfn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got) == len(names)
    for w, g, name in zip(want, got, names):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, name
        if w.dtype.kind == "f":
            assert g.dtype == np.float64, name
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0.0,
                                       err_msg=name)
        else:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)
    return got


@pytest.mark.parametrize("bada", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_phases_matches_jax(seed, bada):
    alt, gs, delalt, cas = _rand_state(N, seed)
    rng = np.random.default_rng(seed + 100)
    vm = [rng.uniform(40.0, 90.0, N) for _ in range(5)]
    bphase = np.radians([15.0, 35.0, 35.0, 35.0, 15.0, 15.0])
    swhdgsel = rng.random(N) < 0.5
    ph, bank = _both(jpl.phases, tpl.phases,
                     (alt, gs, delalt, cas, *vm, np.zeros(N), bphase,
                      swhdgsel, bada), ("phase", "bank"))
    assert set(range(1, 7)) <= set(ph.tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_esf_matches_jax(seed):
    rng = np.random.default_rng(seed)
    alt = rng.uniform(0.0, 14000.0, N)
    mach = rng.uniform(0.2, 0.9, N)
    abco = rng.random(N) < 0.5
    climb = rng.random(N) < 0.4
    descent = ~climb & (rng.random(N) < 0.5)
    delspd = rng.choice([-5.0, 0.0, 5.0], N)
    _both(jpl.esf, tpl.esf, (abco, ~abco, alt, mach, climb, descent,
                             delspd), ("esf",))


@pytest.mark.parametrize("seed", [0, 1])
def test_calclimits_matches_jax(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform
    maxthr = u(80000.0, 250000.0, N)
    args = (u(40.0, 220.0, N), u(0.0, 250.0, N), u(60.0, 90.0, N),
            u(45.0, 80.0, N), u(150.0, 200.0, N), u(0.7, 0.9, N),
            u(0.2, 0.95, N), u(0.0, 13000.0, N), u(9000.0, 13000.0, N),
            u(0.0, 14000.0, N), rng.choice([-5.0, 0.0, 8.0], N), maxthr,
            maxthr * u(0.3, 1.2, N), u(20000.0, 90000.0, N),
            u(60.0, 250.0, N), u(40000.0, 200000.0, N), u(0.3, 1.7, N),
            rng.integers(0, 7, N))
    _both(jpl.calclimits, tpl.calclimits, args,
          ("limspd", "limspd_flag", "limalt", "limalt_flag", "limvs",
           "limvs_flag"))


def _bada_rows(seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform
    alt = u(0.0, 12000.0, N)
    tas = u(5.0, 250.0, N)
    jet, turbo, piston = _engines(rng, N)
    climb = rng.random(N) < 0.4
    descent = ~climb & (rng.random(N) < 0.5)
    phase = rng.integers(1, 7, N)
    return rng, u, alt, tas, jet, turbo, piston, climb, descent, phase


@pytest.mark.parametrize("seed", [5, 6])
def test_bada_thrust_matches_jax(seed):
    rng, u, alt, tas, jet, turbo, piston, climb, descent, phase = \
        _bada_rows(seed)
    ctc = (u(1e5, 3e5, N), u(3e4, 6e4, N), u(1e-11, 1e-10, N))
    _both(jpb.max_climb_thrust, tpb.max_climb_thrust,
          (alt, tas, jet, turbo, piston, *ctc), ("maxthr",))
    thr, _ = _both(
        jpb.thrust, tpb.thrust,
        (phase, climb, descent, ~climb & ~descent, alt, tas,
         u(2e4, 9e4, N), jet, turbo, piston, *ctc, u(0.02, 0.05, N),
         u(0.8, 1.0, N), u(0.1, 0.2, N), u(0.2, 0.4, N),
         u(2000.0, 3000.0, N)), ("thr", "maxthr"))
    assert (thr.numpy() > 0).any()
    _both(jpb.reduced_climb_power, tpb.reduced_climb_power,
          (alt, u(9000.0, 13000.0, N), climb, u(0.0, 0.25, N),
           u(40000.0, 70000.0, N), u(35000.0, 40000.0, N),
           u(72000.0, 80000.0, N)), ("cpred",))


@pytest.mark.parametrize("seed", [5, 6])
def test_bada_fuelflow_matches_jax(seed):
    rng, u, alt, tas, jet, turbo, piston, _, _, phase = _bada_rows(seed)
    _both(jpb.fuelflow, tpb.fuelflow,
          (phase, alt, tas, u(1e4, 2e5, N), jet, turbo, piston,
           u(0.2, 1.0, N), u(100.0, 2000.0, N), u(5.0, 20.0, N),
           u(3e4, 9e4, N), u(0.85, 1.0, N)),
          ("fnom", "fmin", "fcr", "fal"))
