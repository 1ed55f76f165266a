"""The port's main path against the JAX package: ``refresh_spatial_sort``
plus ``run_steps`` under ``SimConfig(cd_backend="sparse")`` on the same
numpy-seeded scene, in float32, the JAX Pallas kernels in interpret mode
and the port's kernels through their plain PyTorch versions (CPU).

Tolerances: integer and bool fields (conflict and LoS counts, the
in-conflict and ASAS-engaged flags, the partner sets) are equal; lat/lon
within 1e-5 deg, altitude within 1e-2 m, speeds and tracks within rtol
1e-4 / atol 1e-3.  The two float32 pipelines differ only in rounding
(rsqrt, summation order of the pair sums), which 21 steps cannot grow
past these bounds.
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


def _run_jax(state, cfg):
    s = jasas.refresh_spatial_sort(state, cfg.asas, block=BLOCK,
                                   impl="sparse")
    return jstep.run_steps(s, cfg, NSTEPS)


def _run_torch(state, cfg):
    s = tasas.refresh_spatial_sort(state, cfg.asas, block=BLOCK,
                                   impl="sparse")
    return tstep.run_steps(s, cfg, NSTEPS)


@pytest.fixture(scope="module")
def stepped():
    """150 aircraft in 256 slots, 21 steps (two ASAS intervals)."""
    jstate, tstate = build_pair(256, 150)
    jcfg = jstep.SimConfig(cd_backend="sparse", cd_block=BLOCK)
    tcfg = tstep.SimConfig(cd_backend="sparse", cd_block=BLOCK)
    j0 = jax_tree_to_numpy(jstate)
    t0 = state_to_numpy(tstate)
    jout, tout = _run_jax(jstate, jcfg), _run_torch(tstate, tcfg)
    return SimpleNamespace(j0=j0, t0=t0, j=jax_tree_to_numpy(jout),
                           t=state_to_numpy(tout), jout=jout, tout=tout)


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
    assert partner_sets(j["asas.partners_s"]) == \
        partner_sets(t["asas.partners_s"])
    assert float(j["simt"]) == float(t["simt"])
    assert float(j["asas_tnext"]) == float(t["asas_tnext"])
    assert float(j["fms_t0"]) == float(t["fms_t0"])


def test_kinematics_within_tolerance(stepped):
    j, t = stepped.j, stepped.t
    for k in ("ac.lat", "ac.lon"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(t["ac.alt"], j["ac.alt"], rtol=0, atol=1e-2)
    for k in ("ac.tas", "ac.gs", "ac.cas", "ac.vs", "ac.gsnorth",
              "ac.gseast", "ac.trk", "ac.hdg", "asas.trk", "asas.tas",
              "asas.vs", "asas.tcpamax", "pilot.trk", "pilot.tas"):
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
    """A second sort refresh, now with engaged partners, moves the
    sorted-space table to the new layout identically in both packages."""
    jout, tout = stepped.jout, stepped.tout
    cfg = tstep.SimConfig(cd_backend="sparse", cd_block=BLOCK).asas
    j = jax_tree_to_numpy(jasas.refresh_spatial_sort(
        jout, jstep.SimConfig().asas, block=BLOCK, impl="sparse"))
    t = state_to_numpy(tasas.refresh_spatial_sort(tout, cfg, block=BLOCK,
                                                  impl="sparse"))
    assert (t["asas.partners_s"] >= 0).sum() > 0
    np.testing.assert_array_equal(t["asas.sort_perm"], j["asas.sort_perm"])
    assert partner_sets(t["asas.partners_s"]) == \
        partner_sets(j["asas.partners_s"])
