"""The port's trajectory optimizer (``bluesky_tpu_torch/diff/
optimize.py``) against the JAX package's, on the CPU in float64.

JAX draws its initial offsets from a ``PRNGKey``, which torch cannot
reproduce, so the port's descent (``descend``) starts from JAX's draw,
moved with ``OffsetParams.from_numpy``; ``optimize`` is ``descend`` from
the port's own seeded draw (``init_offsets``).  Every iterate
(objective, gradient norm, temperatures, offsets) and the hard-metric
verification are held to JAX's ``optimize`` on the same scene, with one
world and with three restarts on the world axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bluesky_tpu.diff import optimize as jopt
from bluesky_tpu_torch.core import asas as tasas
from bluesky_tpu_torch.diff import optimize as topt

from torch_parity import diff_close as _close, diff_pair as _pair

jax.config.update("jax_enable_x64", True)

#: the iterates of a descent: torch's and XLA's float64 differ in the
#: last bits, which the rollouts and the Adam steps lift to ~1e-12
GRAD_RTOL = 1e-9


def _jax_lat0(shape, restarts=1):
    """JAX ``optimize``'s initial lateral offsets (its ``PRNGKey``
    draw, which torch cannot reproduce)."""
    lat0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), shape,
                                   jnp.float64)
    if restarts > 1:
        lat0 = lat0 * jnp.linspace(1.0, 3.0, restarts,
                                   dtype=jnp.float64)[:, None]
    return np.asarray(lat0)


def _assert_results(tres, jres, rtol=GRAD_RTOL):
    for k in ("hard_los_before", "hard_los_after", "bad", "iters",
              "nsteps", "restarts", "best_restart"):
        assert getattr(tres, k) == getattr(jres, k), k
    for k in ("objective", "grad_norm", "temps", "lateral_m", "tshift_s"):
        _close(k, getattr(tres, k), getattr(jres, k), rtol)


OPT_KW = dict(tend=100.0, simdt=1.0, chunk=50, lr=0.5, verify_simdt=0.25)


def test_optimize_matches_jax_and_reaches_zero_los():
    """``descend`` from JAX's initial offsets on a 4-aircraft scene (two
    head-on pairs meeting at ~80 s) follows JAX's ``optimize`` iterate
    for iterate (objective, gradient norm, offsets) to zero hard LoS."""
    jstate, tstate, acfg = _pair(4, leg_km=20.0)
    jres = jopt.optimize(jstate, acfg, iters=5, **OPT_KW)
    lat0 = _jax_lat0((4,))
    tres = topt.descend(
        tstate, topt.OffsetParams.from_numpy(
            {"lateral": lat0, "tshift": np.zeros(4)}, "cpu"),
        tasas.AsasConfig(**acfg._asdict()), iters=5, **OPT_KW)
    _assert_results(tres, jres)
    assert tres.bad == -1 and tres.hard_los_before > 0
    assert tres.hard_los_after == 0
    assert tres.objective[-1] < tres.objective[0]
    payload = tres.to_payload(["A", "B", "C", "D"], [0, 1])
    assert payload["iters"] == 5 and payload["acid"] == ["A", "B"]
    assert len(payload["objective_trace"]) == 5


def test_optimize_restarts_on_the_world_axis():
    """Three restarts stacked on the world axis (``step_worlds``) from
    JAX's widened draw: the same iterates, the same best restart."""
    jstate, tstate, acfg = _pair(2)
    kw = dict(tend=60.0, simdt=1.0, chunk=30, verify_simdt=0.25)
    jres = jopt.optimize(jstate, acfg, iters=3, restarts=3, **kw)
    lat0 = _jax_lat0((3, 2), restarts=3)
    tres = topt.descend(
        tstate, topt.OffsetParams.from_numpy(
            {"lateral": lat0, "tshift": np.zeros((3, 2))}, "cpu"),
        tasas.AsasConfig(**acfg._asdict()), iters=3, **kw)
    _assert_results(tres, jres)
    assert tres.restarts == 3 and tres.bad == -1
    assert tres.lateral_m.shape == (2,)


def test_init_offsets():
    """The port's seeded start: a CPU draw, so every device starts from
    the same numbers; restarts widened 1x to 3x; no time shift."""
    _, tstate, _ = _pair(4)
    a = topt.init_offsets(tstate, seed=3)
    b = topt.init_offsets(tstate, seed=3)
    assert torch.equal(a.lateral, b.lateral) and a.lateral.shape == (4,)
    assert float(a.tshift.abs().max()) == 0.0
    r = topt.init_offsets(tstate, restarts=3, seed=3)
    assert r.lateral.shape == (3, 4)
    draw = 0.1 * torch.randn((3, 4), generator=torch.Generator()
                             .manual_seed(3), dtype=torch.float64)
    torch.testing.assert_close(r.lateral[2], draw[2] * 3.0, rtol=0, atol=0)
