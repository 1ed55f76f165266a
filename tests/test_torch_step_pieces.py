"""The per-aircraft pieces of the step against the JAX package in
float64: kinematics, performance, pilot arbitration and envelope limits,
the FMS (waypoint switching, VNAV, speed guidance) and the wind lookup.

The scene is built once through the JAX ``Traffic`` and ``RouteManager``
(routes with altitude and speed constraints, some waypoints already
within turn distance so the FMS switches), perturbed with numpy-seeded
values, and carried to the port with ``state_from_numpy``.  Each piece
runs in both packages on the same state; every output field agrees at
rtol 1e-12 (atol 1e-9 for values that are differences of large ones).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from bluesky_tpu.core import autopilot as jap, kinematics as jkin, \
    perf as jperf, pilot as jpilot, wind as jwind
from bluesky_tpu.core.route import RouteManager
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu_torch.core import autopilot as tap, kinematics as tkin, \
    perf as tperf, pilot as tpilot, wind as twind
from bluesky_tpu_torch.core.state import state_from_numpy, state_to_numpy

from torch_parity import jax_tree_to_numpy, scene

NMAX, N = 64, 48


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(7)
    lat, lon, hdg, alt, spd = scene(N, seed=3)
    jt = JTraffic(nmax=NMAX, dtype=jnp.float64, pair_matrix=False)
    jt.create(N, "B744", alt, spd, None, lat, lon, hdg)
    jt.flush()
    rm = RouteManager(jt, wmax=jt.wmax)
    for i in range(40):
        # the first waypoint lies 0.3-20 nm ahead, or for every third
        # aircraft 0.5-3 nm behind, inside the turn circle: reached
        behind = i % 3 == 0
        d = rng.uniform(0.5, 3.0) / 60.0 if behind else \
            rng.uniform(0.3, 20.0) / 60.0
        q = np.radians(hdg[i] + 180.0 * behind + rng.uniform(-30, 30))
        wlat, wlon = lat[i] + d * np.cos(q), lon[i] + d * np.sin(q) / np.cos(
            np.radians(lat[i]))
        for k in range(3):
            a = float(rng.uniform(3000, 11000)) if rng.random() < 0.6 \
                else -999.0
            s = float(rng.uniform(130, 240)) if k == 1 else -999.0
            if k == 2 and rng.random() < 0.3:
                s = float(rng.uniform(0.7, 0.85))          # a Mach constraint
            rm.addwpt(i, f"W{i}_{k}", wlat + 0.3 * k, wlon + 0.2 * k,
                      alt=a, spd=s)
        rm.sync(i, point_active=True)
    st = jt.state
    f = lambda a: jnp.asarray(a, jnp.float64)
    ac = st.ac.replace(
        vs=f(rng.uniform(-12, 12, NMAX)),
        selalt=f(rng.uniform(3000, 11000, NMAX)),
        selvs=f(np.where(rng.random(NMAX) < 0.5, 0.0,
                         rng.uniform(-10, 10, NMAX))),
        swvnav=jnp.asarray(rng.random(NMAX) < 0.6) & st.ac.swlnav,
        abco=jnp.asarray(rng.random(NMAX) < 0.3),
        swaltsel=jnp.asarray(rng.random(NMAX) < 0.5),
        bank=f(np.radians(rng.uniform(15, 35, NMAX))))
    ac = ac.replace(belco=~ac.abco)
    asas = st.asas.replace(
        active=jnp.asarray(rng.random(NMAX) < 0.3),
        trk=f(rng.uniform(0, 360, NMAX)), tas=f(rng.uniform(120, 250, NMAX)),
        alt=f(rng.uniform(3000, 11000, NMAX)),
        vs=f(rng.uniform(-10, 10, NMAX)))
    pilot = st.pilot.replace(
        trk=f(rng.uniform(0, 360, NMAX)), hdg=f(rng.uniform(0, 360, NMAX)),
        tas=f(rng.uniform(100, 260, NMAX)),
        alt=f(rng.uniform(0, 13000, NMAX)), vs=f(rng.uniform(0, 15, NMAX)))
    jstate = st.replace(ac=ac, asas=asas, pilot=pilot)
    wind = jwind.make_windstate(dtype=jnp.float64)
    wind = jwind.add_point(wind, 52.0, 4.0, 270.0, 20.0)
    wind = jwind.add_point(wind, 53.5, 6.0, 200.0, [10.0, 30.0, 45.0],
                           windalt=[0.0, 5000.0, 12000.0])
    jstate = jstate.replace(wind=wind)
    return jstate, state_from_numpy(jax_tree_to_numpy(jstate), device="cpu")


def close_tree(t, j, rtol=1e-12, atol=1e-9):
    tn = state_to_numpy(t) if hasattr(t, "ac") else {
        k: np.asarray(v) for k, v in vars(t).items()}
    jn = jax_tree_to_numpy(j)
    if not hasattr(t, "ac"):
        jn = {k.split(".")[-1]: v for k, v in jn.items()}
    assert sorted(tn) == sorted(jn)
    for k in jn:
        if k == "rng":
            continue
        a, b = np.asarray(tn[k]), np.asarray(jn[k])
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_fms(states):
    js, ts = states
    jout = jap.update_fms(js)
    tout = tap.update_fms(ts)
    moved = np.asarray(jout.route.iactwp) != np.asarray(js.route.iactwp)
    assert moved.any()                       # some aircraft switched
    close_tree(tout, jout)
    close_tree(tap.update_continuous(tout), jap.update_continuous(jout))


def test_pilot_and_limits(states):
    js, ts = states
    jw = jwind.getdata(js.wind, js.ac.lat, js.ac.lon, js.ac.alt)
    tw = twind.getdata(ts.wind, ts.ac.lat, ts.ac.lon, ts.ac.alt)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    for wind in (False, True):
        jargs = jw if wind else (None, None)
        targs = tw if wind else (None, None)
        jout = jpilot.ap_or_asas(js, *jargs)
        tout = tpilot.ap_or_asas(ts, *targs)
        close_tree(tout, jout)
        close_tree(tpilot.apply_limits(tout), jpilot.apply_limits(jout))


def test_perf(states):
    js, ts = states
    jp, jbank = jperf.update(js.perf, js.ac.tas, js.ac.vs, js.ac.alt)
    tp, tbank = tperf.update(ts.perf, ts.ac.tas, ts.ac.vs, ts.ac.alt)
    close_tree(tp, jp)
    np.testing.assert_allclose(tbank.numpy(), np.asarray(jbank), rtol=1e-12)
    assert len(set(np.asarray(jp.phase).tolist())) > 1
    np.testing.assert_array_equal(
        tperf.acceleration(tp.phase, ts.ac.tas).numpy(),
        np.asarray(jperf.acceleration(jp.phase)))


def test_kinematics(states):
    js, ts = states
    simdt = 0.05
    jac = jkin.update_atmosphere(js.ac)
    tac = tkin.update_atmosphere(ts.ac)
    close_tree(tac, jac)
    jacc = jperf.acceleration(js.perf.phase)
    tacc = tperf.acceleration(ts.perf.phase, ts.ac.tas)
    jac = jkin.update_airspeed(jac, js.pilot, jacc, simdt)
    tac = tkin.update_airspeed(tac, ts.pilot, tacc, simdt)
    close_tree(tac, jac)
    jw = jwind.getdata(js.wind, js.ac.lat, js.ac.lon, js.ac.alt)
    tw = twind.getdata(ts.wind, ts.ac.lat, ts.ac.lon, ts.ac.alt)
    for jargs, targs in (((None, None), (None, None)), (jw, tw)):
        jg = jkin.update_groundspeed(jac, *jargs)
        tg = tkin.update_groundspeed(tac, *targs)
        close_tree(tg, jg)
        close_tree(tkin.update_position(tg, ts.pilot, simdt),
                   jkin.update_position(jg, js.pilot, simdt))
