"""The port's main path against the JAX package: ``refresh_spatial_sort``
plus ``run_steps`` under ``SimConfig(cd_backend=..., asas=AsasConfig(
reso_method=...))`` for each of the four backends and each of the four
resolvers on the same numpy-seeded scene, in float32, the JAX Pallas
kernels in interpret mode and the port's kernels through their plain
PyTorch versions (CPU).  The pair state compared is the one each backend
keeps: the [N, N] ``resopairs`` (dense, equal), the sorted-space
``partners_s`` (sparse) or the caller-space ``partners`` (tiled,
pallas), as partner sets.

Tolerances: integer and bool fields (conflict and LoS counts, the
in-conflict and ASAS-engaged flags, the partner sets) are equal; lat/lon
within 1e-5 deg, altitude within 1e-2 m, speeds and tracks within rtol
1e-4 / atol 1e-3.  The two float32 pipelines differ only in rounding
(rsqrt, summation order of the pair sums), which 21 steps cannot grow
past these bounds.  Under EBY the commanded track, speed and vertical
speed (``asas.*``, and the ``pilot.*`` that follow them) are held to
the JAX package's own bound between its float32 Eby backends
(``tests/test_resolvers_blockwise.py``: tracks 0.3 deg at the 99th
percentile and 5 deg at most, speeds 0.05 and 1.0 m/s): JAX computes
each Eby pair in float32, where a near-grazing pair's quadratic
cancels, the port in float64 (``ops/cr_eby.py``).
"""
from types import SimpleNamespace

import numpy as np
import pytest

from bluesky_tpu.core import asas as jasas, step as jstep
from bluesky_tpu_torch.core import asas as tasas, step as tstep
from bluesky_tpu_torch.core.state import state_from_numpy, state_to_numpy

from torch_parity import build_pair, jax_tree_to_numpy, partner_sets

NSTEPS = 21
BLOCK = 64


#: the pair state each backend keeps
TABLE = {"dense": "asas.resopairs", "tiled": "asas.partners",
         "sparse": "asas.partners_s", "pallas": "asas.partners"}


def _run_jax(state, cfg):
    s = jasas.refresh_spatial_sort(
        state, cfg.asas, block=BLOCK,
        impl=jasas.impl_for_backend(cfg.cd_backend))
    return jstep.run_steps(s, cfg, NSTEPS)


def _run_torch(state, cfg):
    s = tasas.refresh_spatial_sort(
        state, cfg.asas, block=BLOCK,
        impl=tasas.impl_for_backend(cfg.cd_backend))
    return tstep.run_steps(s, cfg, NSTEPS)


def assert_tables_equal(backend, j, t):
    """The dense ``resopairs`` equal; a partner table's rows equal as
    sets.  Fails on an empty table too."""
    if backend == "dense":
        assert t.sum() > 0
        np.testing.assert_array_equal(t, j)
    else:
        assert (t >= 0).sum() > 0
        assert partner_sets(j) == partner_sets(t)


@pytest.fixture(scope="module", params=[
    (backend, reso) for reso in ("MVP", "EBY", "SWARM", "SSD")
    for backend in ("dense", "tiled", "sparse", "pallas")],
    ids=lambda p: p[0] if p[1] == "MVP" else f"{p[0]}-{p[1]}")
def stepped(request):
    """150 aircraft in 256 slots, 21 steps (two ASAS intervals)."""
    backend, reso = request.param
    jstate, tstate = build_pair(256, 150, pair_matrix=backend == "dense")
    jcfg = jstep.SimConfig(cd_backend=backend, cd_block=BLOCK,
                           asas=jasas.AsasConfig(reso_method=reso))
    tcfg = tstep.SimConfig(cd_backend=backend, cd_block=BLOCK,
                           asas=tasas.AsasConfig(reso_method=reso))
    j0 = jax_tree_to_numpy(jstate)
    t0 = state_to_numpy(tstate)
    jout, tout = _run_jax(jstate, jcfg), _run_torch(tstate, tcfg)
    return SimpleNamespace(j0=j0, t0=t0, j=jax_tree_to_numpy(jout),
                           t=state_to_numpy(tout), jout=jout, tout=tout,
                           backend=backend, reso=reso, table=TABLE[backend])


def test_traffic_builds_the_same_state(stepped):
    """Both ``Traffic.create/flush`` give the same initial state."""
    j0, t0 = stepped.j0, stepped.t0
    for k in j0:
        if k == "rng":
            continue
        np.testing.assert_array_equal(j0[k], t0[k], err_msg=k)


def test_counts_and_flags_equal(stepped):
    j, t = stepped.j, stepped.t
    assert int(j["asas.nconf_cur"]) > 0
    for k in ("asas.nconf_cur", "asas.nlos_cur", "asas.inconf",
              "asas.active", "ac.active", "asas.sort_perm", "perf.phase",
              "ac.swhdgsel", "ac.swaltsel"):
        np.testing.assert_array_equal(j[k], t[k], err_msg=k)
    assert_tables_equal(stepped.backend, j[stepped.table], t[stepped.table])
    assert float(j["simt"]) == float(t["simt"])
    assert float(j["asas_tnext"]) == float(t["asas_tnext"])
    assert float(j["fms_t0"]) == float(t["fms_t0"])


#: the commands a float32 Eby pair moves (module docstring), with the
#: JAX package's bound at the 99th percentile and at most
EBY_COMMANDS = {"asas.trk": (0.3, 5.0), "asas.tas": (0.05, 1.0),
                "asas.vs": (0.05, 1.0), "pilot.trk": (0.3, 5.0),
                "pilot.tas": (0.05, 1.0)}


def test_kinematics_within_tolerance(stepped):
    j, t = stepped.j, stepped.t
    for k in ("ac.lat", "ac.lon"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(t["ac.alt"], j["ac.alt"], rtol=0, atol=1e-2)
    eby = stepped.reso == "EBY"
    for k in ("ac.tas", "ac.gs", "ac.cas", "ac.vs", "ac.gsnorth",
              "ac.gseast", "ac.trk", "ac.hdg", "asas.trk", "asas.tas",
              "asas.vs", "asas.tcpamax", "pilot.trk", "pilot.tas"):
        if eby and k in EBY_COMMANDS:
            d = np.abs(t[k].astype(np.float64) - j[k])
            if k.endswith("trk"):
                d = np.minimum(d, 360.0 - d)
            p99, most = EBY_COMMANDS[k]
            assert np.percentile(d, 99) < p99 and d.max() < most, \
                (k, np.percentile(d, 99), d.max())
            continue
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-3,
                                   err_msg=k)


def test_state_round_trip_after_steps(stepped):
    """The stepped JAX state survives the port's numpy round trip."""
    j = stepped.j
    back = state_to_numpy(state_from_numpy(j, device="cpu"))
    for k in j:
        assert back[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(back[k], j[k], err_msg=k)


def test_refresh_remaps_the_partner_table(stepped):
    """A second sort refresh, now with engaged partners, gives the same
    sort and pair state in both packages: the sparse refresh moves the
    sorted-space table to the new layout, the Morton refresh of the
    other backends leaves the caller-space table (or ``resopairs``) as it
    is."""
    jout, tout = stepped.jout, stepped.tout
    impl = tasas.impl_for_backend(stepped.backend)
    cfg = tstep.SimConfig(cd_backend=stepped.backend, cd_block=BLOCK).asas
    j = jax_tree_to_numpy(jasas.refresh_spatial_sort(
        jout, jstep.SimConfig().asas, block=BLOCK, impl=impl))
    t = state_to_numpy(tasas.refresh_spatial_sort(tout, cfg, block=BLOCK,
                                                  impl=impl))
    np.testing.assert_array_equal(t["asas.sort_perm"], j["asas.sort_perm"])
    assert_tables_equal(stepped.backend, j[stepped.table], t[stepped.table])
    if impl != "sparse":
        np.testing.assert_array_equal(t[stepped.table],
                                      stepped.t[stepped.table])
