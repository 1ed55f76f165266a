"""The port's differentiable mode (``bluesky_tpu_torch/diff``) against
the JAX package's (``bluesky_tpu/diff``), on the CPU in float64.

Both packages start from the same numpy state (the JAX scene moved with
``state_from_numpy``) and the same offsets (``OffsetParams.from_numpy``):

* the relaxations of ``diff/smooth.py``, values and gradients, with the
  clip ties (``jnp.clip`` passes 0.5 at a bound, ``torch.clamp`` 1) and
  ``softmin_weighted``'s fully masked rows;
* the smooth step for 40 steps, ASAS in and out of the loop; the
  ``smooth=None`` step bit-equal to the step with ``torch.clamp``
  (the clips of the step before the differentiable mode);
* the rollout's value and gradient and ``grad_once`` against
  ``jax.value_and_grad`` (rtol ``GRAD_RTOL``); the checkpointed rollout
  against one checkpoint and against none;
* finite differences against the port's gradient (JAX
  ``tests/test_diff.py``'s checks); the guard words;
* the dense-only and MVP-only ``ValueError``s.

The optimizer itself: ``tests/test_torch_diff_opt.py``.

The scene is JAX's ``conflict_scene`` (head-on pairs with LNAV-direct
routes to each other's start).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import step as jstep
from bluesky_tpu.diff import objectives as jobj, optimize as jopt, \
    smooth as jsmooth
from bluesky_tpu.ops import cd as jcd
from bluesky_tpu_torch.core import asas as tasas, step as tstep
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.diff import objectives as tobj, optimize as topt, \
    smooth as tsmooth
from bluesky_tpu_torch.ops import cd as tcd, ties

from torch_parity import diff_close as _close, diff_pair as _pair, \
    diff_params as _params, diff_scene as _scene, jax_tree_to_numpy

jax.config.update("jax_enable_x64", True)

#: value and gradient of a rollout: torch's and XLA's float64 differ in
#: the last bits, which 100 steps of closed-loop dynamics lift to ~1e-12
GRAD_RTOL = 1e-9
#: the states after 40 smooth steps (``torch_parity.SIM_RTOL``'s bound)
STATE_RTOL = 1e-9


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_conflict_scene_matches_jax():
    """The port's ``conflict_scene`` builds JAX's state bit for bit."""
    tree, _, acfg = _scene(4)
    traf, tacfg = topt.conflict_scene(4, dtype=torch.float64, device="cpu")
    got = state_to_numpy(traf.state)
    assert sorted(got) == sorted(tree)
    for k in tree:
        assert got[k].dtype == tree[k].dtype, k
        assert np.array_equal(got[k], tree[k], equal_nan=True), k
    assert tacfg._asdict() == acfg._asdict()
    assert traf.ids[:4] == ["OPT000", "OPT001", "OPT002", "OPT003"]


# ------------------------------------------------------------- smooth.py
def test_clip_ties():
    """``ties.clip``/``maximum`` take JAX's gradient at a tie (0.5 at a
    bound) where ``torch.clamp`` passes 1; the forward values agree."""
    x = np.array([1.0, 0.0, 0.5, -2.0, 3.0])
    gj = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = ties.clip(xt, 0.0, 1.0)
    gt, = torch.autograd.grad(y.sum(), xt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(gt.numpy(), [0.5, 0.5, 1.0, 0.0, 0.0])
    np.testing.assert_array_equal(y.detach().numpy(),
                                  torch.clamp(_t(x), 0.0, 1.0).numpy())
    gc, = torch.autograd.grad(torch.clamp(xt, 0.0, 1.0).sum(), xt)
    assert gc[:2].tolist() == [1.0, 1.0]        # the tie torch.clamp takes
    gj = jax.grad(lambda v: jnp.maximum(v, 0.5).sum())(jnp.asarray(x))
    gt, = torch.autograd.grad(ties.maximum(xt, 0.5).sum(), xt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    lo, hi = _t([0.0, 1.0, 2.0, 0.5, 1.0]), _t([1.0, 1.0, 3.0, 2.0, 2.0])
    gj = jax.grad(lambda v: jnp.clip(v, jnp.asarray(lo.numpy()),
                                     jnp.asarray(hi.numpy())).sum())(
        jnp.asarray(x))
    gt, = torch.autograd.grad(ties.clip(xt, lo, hi).sum(), xt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    nan = _t([np.nan, 1.0])
    assert torch.equal(ties.clip(nan, 0.0, 0.5).isnan(),
                       torch.clamp(nan, 0.0, 0.5).isnan())


def _jt_grad(fj, ft, *args):
    """Value and gradient (in the first argument) of the sum of ``fj``
    (JAX) and ``ft`` (port) at the numpy ``args``."""
    vj, gj = jax.value_and_grad(lambda a, *r: jnp.sum(fj(a, *r)))(
        *[jnp.asarray(a) for a in args])
    xt = _t(args[0]).requires_grad_()
    vt = ft(xt, *[_t(a) for a in args[1:]]).sum()
    gt, = torch.autograd.grad(vt, xt)
    return (float(vj), np.asarray(gj)), (float(vt.detach()), gt.numpy())


@pytest.mark.parametrize("fn", ["ste_clip", "capture_step", "softmin",
                                "softmax", "soft_los_weight", "sigmoid"])
def test_smooth_functions_match_jax(fn):
    """Each relaxation's value and gradient against JAX's, with bounds
    hit exactly (the straight-through clips pass 1 there)."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 2.0, (5, 6))
    x[0, :3] = [1.0, -1.0, 0.0]                 # exactly at the bounds
    w = rng.uniform(0.0, 1.0, (5, 6))
    w[1] = 0.0                                  # a fully masked row
    w[2, ::2] = 0.0
    case = {
        "ste_clip": (lambda a: jsmooth.ste_clip(a, -1.0, 1.0),
                     lambda a: tsmooth.ste_clip(a, -1.0, 1.0), (x,)),
        "capture_step": (jsmooth.capture_step, tsmooth.capture_step,
                         (x, np.abs(w) + 0.5)),
        "softmin": (lambda a, b: jsmooth.softmin_weighted(a, b, 0.7),
                    lambda a, b: tsmooth.softmin_weighted(a, b, 0.7),
                    (x, w)),
        "softmax": (lambda a, b: jsmooth.softmax_weighted(a, b, 0.3),
                    lambda a, b: tsmooth.softmax_weighted(a, b, 0.3),
                    (x, w)),
        "soft_los_weight": (
            lambda a, b: jsmooth.soft_los_weight(9260.0 * (1 + a), 300 * b,
                                                 9260.0, 304.8, 0.2),
            lambda a, b: tsmooth.soft_los_weight(9260.0 * (1 + a), 300 * b,
                                                 9260.0, 304.8, 0.2),
            (x, w)),
        "sigmoid": (jsmooth.sigmoid, tsmooth.sigmoid, (x,)),
    }[fn]
    (vj, gj), (vt, gt) = _jt_grad(case[0], case[1], *case[2])
    assert vt == pytest.approx(vj, rel=1e-14, abs=1e-300)
    np.testing.assert_allclose(gt, gj, rtol=1e-13, atol=1e-300)
    if fn == "ste_clip":
        assert np.all(gt == 1.0)
    if fn == "softmin":
        # a row without weight returns big, like the hard min over none
        out = tsmooth.softmin_weighted(_t(x), _t(w), 0.7)
        assert float(out[1]) == 1e9
        hard = tsmooth.softmin_weighted(_t(x), _t(w), 1e-4)
        want = np.where(w > 0, x, 1e9).min(-1)
        np.testing.assert_allclose(hard.numpy()[[0, 2, 3, 4]],
                                   want[[0, 2, 3, 4]], atol=1e-6)


def test_soft_conflict_weight_matches_jax():
    """``soft_conflict_weight`` on the detect of the same columns, and
    the detect's masked and diagonal pairs at weight exactly 0 (their
    ``dcpa2``, ``tinconf`` and ``toutconf`` finite, as JAX's)."""
    rng = np.random.default_rng(5)
    n = 8
    cols = dict(lat=rng.uniform(51.9, 52.1, n), lon=rng.uniform(3.9, 4.1, n),
                trk=rng.uniform(0, 360, n), gs=rng.uniform(150, 250, n),
                alt=rng.uniform(9000, 9400, n), vs=rng.uniform(-5, 5, n),
                active=np.arange(n) < 6)
    args = [cols[k] for k in ("lat", "lon", "trk", "gs", "alt", "vs",
                              "active")]
    cdj = jcd.detect(*[jnp.asarray(a) for a in args], 9260.0, 304.8, 300.0)
    cdt = tcd.detect(*[_t(a) for a in args], 9260.0, 304.8, 300.0)
    sm = jsmooth.SmoothConfig()
    wj = np.asarray(jsmooth.soft_conflict_weight(cdj, 9260.0, 300.0, sm))
    wt = tsmooth.soft_conflict_weight(cdt, 9260.0, 300.0,
                                      tsmooth.SmoothConfig()).numpy()
    np.testing.assert_allclose(wt, wj, rtol=1e-12, atol=1e-300)
    excluded = ~(cols["active"][:, None] & cols["active"][None, :]) \
        | np.eye(n, dtype=bool)
    assert np.all(wt[excluded] == 0.0) and np.any(wt[~excluded] > 0.1)
    for k in ("dcpa2", "tinconf", "toutconf"):
        a, b = getattr(cdt, k).numpy(), np.asarray(getattr(cdj, k))
        assert np.all(np.isfinite(a)), k
        np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=k)
    assert tuple(tsmooth.SmoothConfig()) == tuple(sm)


def test_objectives_match_jax():
    """The soft-LoS, fuel and deviation terms and the hard count on the
    same state, and the annealing contract of the soft-LoS weight."""
    jstate, tstate, acfg = _pair(4, leg_km=5.0)
    rpz, hpz = float(acfg.rpz), float(acfg.hpz)
    for t in (1e-3, 0.3, 1.0):
        assert float(tobj.soft_los_cost(tstate, rpz, hpz, t)) \
            == pytest.approx(float(jobj.soft_los_cost(jstate, rpz, hpz, t)),
                             rel=1e-12)
    w = tobj.ObjectiveWeights()
    assert tuple(w) == tuple(jobj.ObjectiveWeights())
    assert float(tobj.step_cost(tstate, rpz, hpz, w, 0.3, 1.0)) \
        == pytest.approx(float(jobj.step_cost(jstate, rpz, hpz, w, 0.3,
                                              1.0)), rel=1e-12)
    hard = int(tobj.hard_los_count(tstate, rpz, hpz))
    assert hard == int(jobj.hard_los_count(jstate, rpz, hpz)) > 0
    assert float(tobj.soft_los_cost(tstate, rpz, hpz, 1e-3)) \
        == pytest.approx(hard / 2.0, abs=1e-3)
    p = _params(4, 1)
    assert float(tobj.deviation_penalty(_t(p["lateral"]), _t(p["tshift"]),
                                        rpz, w)) == pytest.approx(
        float(jobj.deviation_penalty(jnp.asarray(p["lateral"]),
                                     jnp.asarray(p["tshift"]), rpz, w)),
        rel=1e-14)
    assert tobj.anneal_schedule(0.3, 0.05, 7) \
        == jobj.anneal_schedule(0.3, 0.05, 7)
    w_in = [float(tsmooth.soft_los_weight(_t(0.5 * rpz), _t(0.0), rpz, hpz,
                                          t)) for t in (1.0, 0.2, 0.02)]
    assert w_in == sorted(w_in) and w_in[-1] > 0.999


# ------------------------------------------------------------ the step
def _smooth_cfgs(acfg, with_asas):
    acfg = acfg if with_asas else acfg._replace(swasas=False)
    return (jstep.SimConfig(simdt=1.0, asas=acfg, cd_backend="dense",
                            smooth=jsmooth.SmoothConfig()),
            tstep.SimConfig(simdt=1.0, asas=tasas.AsasConfig(**acfg._asdict()),
                            cd_backend="dense",
                            smooth=tsmooth.SmoothConfig()))


@pytest.mark.parametrize("with_asas", [False, True])
def test_smooth_step_matches_jax(with_asas):
    """40 smooth steps of a 4-aircraft head-on scene (the pairs meet in
    the window, so the sigmoid weights, the softmin and the
    straight-through caps all act with ASAS on), field by field."""
    jstate, tstate, acfg = _pair(4, leg_km=15.0)
    jcfg, tcfg = _smooth_cfgs(acfg, with_asas)
    js = jstep.run_steps(jstate, jcfg, 40)
    ts = tstep.run_steps(tstate, tcfg, 40)
    a, b = jax_tree_to_numpy(js), state_to_numpy(ts)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        if x.dtype.kind != "f":
            assert np.array_equal(x, y), k
        else:
            d = np.abs(x - y)
            if k.endswith(("trk", "hdg")):
                d = np.minimum(d, 360.0 - d)
            assert np.all((d <= 1e-9 + STATE_RTOL * np.abs(x))
                          | (np.isnan(x) & np.isnan(y))), (k, d.max())
    if with_asas:
        assert int(np.asarray(a["asas.inconf"]).sum()) > 0


def _clamp_ties(monkeypatch):
    """The clips of the step before the differentiable mode."""
    monkeypatch.setattr(ties, "maximum", lambda x, c: torch.clamp_min(x, c))
    monkeypatch.setattr(ties, "minimum", lambda x, c: torch.clamp_max(x, c))
    monkeypatch.setattr(ties, "clip", lambda x, lo, hi: torch.clamp(x, lo, hi))


def test_smooth_none_is_the_serving_step(monkeypatch):
    """``SimConfig.smooth`` defaults to None, and the step with it is
    bit-equal to the step whose clips are ``torch.clamp`` (the code
    before this mode; noise on, ASAS on, the resolver engaged), while a
    ``SmoothConfig`` changes the trajectory."""
    assert tstep.SimConfig().smooth is None
    from bluesky_tpu_torch.core.noise import NoiseConfig
    from bluesky_tpu_torch.simulation.sim import Simulation
    assert Simulation(nmax=4, device="cpu").cfg.smooth is None
    _, tstate, acfg = _pair(4, leg_km=15.0)
    cfg = tstep.SimConfig(simdt=0.5, asas=tasas.AsasConfig(**acfg._asdict()),
                          noise=NoiseConfig(turb_active=True,
                                            adsb_transnoise=True))
    runs = [tstep.run_steps(tstate, cfg, 60)]
    with monkeypatch.context() as m:
        _clamp_ties(m)
        runs.append(tstep.run_steps(tstate, cfg, 60))
    runs.append(tstep.run_steps(tstate, cfg._replace(
        smooth=tsmooth.SmoothConfig()), 60))
    a, b, c = (state_to_numpy(s) for s in runs)
    assert int(a["asas.inconf"].sum()) > 0
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
    assert any(not np.array_equal(a[k], c[k], equal_nan=True) for k in a)


def test_smooth_refuses_other_backends_and_resolvers():
    """Differentiable mode is the dense backend's and MVP's (or RESO
    OFF), as in JAX: both raise ``ValueError``."""
    _, tstate, acfg = _pair(2)
    tacfg = tasas.AsasConfig(**acfg._asdict())
    sm = tsmooth.SmoothConfig()
    for backend in ("tiled", "pallas", "sparse"):
        with pytest.raises(ValueError, match="dense"):
            tstep.step(tstate, tstep.SimConfig(cd_backend=backend,
                                               asas=tacfg, smooth=sm))
    for method in ("EBY", "SWARM", "SSD"):
        cfg = tacfg._replace(reso_method=method)
        with pytest.raises(ValueError, match="MVP"):
            tasas.update(tstate, cfg, smooth=sm)
        with pytest.raises(ValueError, match="MVP"):
            tstep.step(tstate, tstep.SimConfig(asas=cfg, smooth=sm))
    off = tacfg._replace(reso_method="EBY", reso_on=False)
    tstep.step(tstate, tstep.SimConfig(asas=off, smooth=sm))
    tstep.step(tstate, tstep.SimConfig(asas=tacfg._replace(swasas=False),
                                       cd_backend="tiled", smooth=sm))


# ----------------------------------------------------- value and gradient
ROLL_CHUNK = 50


def _roll_steps(with_asas):
    """The rollout's steps: 100, or 50 with ASAS in the loop (an [N, N]
    interval each step makes the CPU backward slow)."""
    return 50 if with_asas else 100


def _leg(with_asas):
    """The scene's half-leg [km]: the pairs meet at ~80 s (20 km) or
    ~250 s (60 km).  With ASAS in the loop the 20 km pairs reach MVP's
    altitude-capture knife edge at step 31: a 0.5-ulp altitude
    difference (XLA fuses the multiply-add) flips ``swaltsel`` (ROADMAP
    §C, "Known"); the 60 km pairs, resolving from the first step, meet
    none in 100 steps."""
    return 60.0 if with_asas else 20.0


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(with_asas):
    """JAX's jitted value and gradient of the rollout objective
    (``apply_offsets`` then ``_rollout``, los_margin 1.2) of the 4-aircraft
    scene, in (params, state, temp)."""
    _, _, acfg = _pair(4)
    jcfg, _ = _smooth_cfgs(acfg, with_asas)
    rpz = float(acfg.rpz)

    def cost(p, s, temp):
        acc, _, bad = jopt._rollout(jopt.apply_offsets(s, p, rpz), jcfg,
                                    _roll_steps(with_asas), ROLL_CHUNK,
                                    jobj.ObjectiveWeights(), temp, False,
                                    los_margin=1.2)
        return acc, bad
    return jax.jit(jax.value_and_grad(cost, has_aux=True))


def _port_value_and_grad(tstate, acfg, with_asas, params, temp,
                         nsteps=None, chunk=ROLL_CHUNK, noise=None):
    _, tcfg = _smooth_cfgs(acfg, with_asas)
    nsteps = nsteps or _roll_steps(with_asas)
    if noise is not None:
        tcfg = tcfg._replace(noise=noise)
    rpz = float(acfg.rpz)

    def cost(p, s, t):
        acc, _, bad = topt._rollout(topt.apply_offsets(s, p, rpz), tcfg,
                                    nsteps, chunk,
                                    tobj.ObjectiveWeights(), t, False,
                                    los_margin=1.2)
        return acc, {"bad": bad}
    value, aux, grads, bad = topt.checked_value_and_grad(cost)(
        params, tstate, temp)
    return value, grads, bad, aux["bad"]


@pytest.mark.parametrize("with_asas", [False, True])
def test_rollout_and_grad_once_match_jax(with_asas):
    """The rollout objective and its gradient at seeded offsets (temp
    0.3), and ``grad_once`` at zero offsets (temp 1.0), against
    ``jax.value_and_grad``.  With ASAS in the loop both packages give
    non-finite time-shift gradients (``sqrt(max(0, r2 - dcpa2))`` at 0
    in ``cd.detect``), the same entries, and the guard word -3."""
    jstate, tstate, acfg = _pair(4, leg_km=_leg(with_asas))
    vg = _jax_value_and_grad(with_asas)
    p = _params(4, 7)
    (vj, badj), gj = vg(jopt.OffsetParams(**{k: jnp.asarray(v)
                                              for k, v in p.items()}),
                        jstate, jnp.asarray(0.3))
    value, grads, bad, fwd = _port_value_and_grad(
        tstate, acfg, with_asas, topt.OffsetParams.from_numpy(p, "cpu"), 0.3)
    assert int(fwd) == int(badj) == -1
    _close("value", float(value), float(vj), GRAD_RTOL)
    for k, g in grads.to_numpy().items():
        _close(k, g, np.asarray(getattr(gj, k)), GRAD_RTOL)
    if not with_asas:
        assert np.any(np.asarray(gj.lateral) != 0.0)
    gfin = all(np.all(np.isfinite(np.asarray(g))) for g in gj)
    assert int(bad) == (-1 if gfin else topt.GUARD_BAD_GRADS)
    assert gfin != with_asas

    z = jopt.OffsetParams(jnp.zeros(4), jnp.zeros(4))
    (vj, _), gj = vg(z, jstate, jnp.asarray(1.0))
    gnorm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in gj)))
    v, gn, bad = topt.grad_once(tstate, tasas.AsasConfig(**acfg._asdict()),
                                tend=_roll_steps(with_asas), chunk=ROLL_CHUNK,
                                with_asas=with_asas)
    _close("grad_once value", v, float(vj), GRAD_RTOL)
    _close("grad_once |grad|", gn, gnorm, GRAD_RTOL)
    assert bad == (-1 if np.isfinite(gnorm) else topt.GUARD_BAD_GRADS)


@pytest.mark.parametrize("with_asas", [False, True])
def test_checkpointed_matches_unchecked(with_asas, monkeypatch):
    """Chunks of 10 under ``torch.utils.checkpoint`` against one
    checkpoint over the whole 40-step rollout (``chunk == nsteps``) and
    against plain autograd with no checkpoint, noise on: the recompute
    takes the same gates and the same noise draws, so every gradient is
    bit-equal."""
    from bluesky_tpu_torch.core.noise import NoiseConfig
    _, tstate, acfg = _pair(4, leg_km=20.0)
    p = topt.OffsetParams.from_numpy(_params(4, 11), "cpu")
    run = functools.partial(
        _port_value_and_grad, tstate, acfg, with_asas, p, 0.3, nsteps=40,
        noise=NoiseConfig(turb_active=True, adsb_transnoise=True))
    ck, one = run(chunk=10), run(chunk=40)
    monkeypatch.setattr(topt, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    plain = run(chunk=10)
    for other in (one, plain):
        assert torch.equal(ck[0], other[0])
        for g, h in zip(ck[1], other[1]):
            assert torch.equal(g.isnan(), h.isnan())
            assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(h))
        assert int(ck[2]) == int(other[2])


def _fd_check(cost, params, coords, eps=1e-5, rtol=5e-3, atol=1e-7):
    """Central finite differences against the port's gradient."""
    leaves = [x.clone().requires_grad_() for x in params]
    g = torch.autograd.grad(cost(topt.OffsetParams(*leaves)), leaves)
    g = topt.OffsetParams(*g)
    for name, idx in coords:
        up = {k: getattr(params, k).clone() for k in params._fields}
        dn = {k: getattr(params, k).clone() for k in params._fields}
        up[name][idx] += eps
        dn[name][idx] -= eps
        with torch.no_grad():
            fd = (float(cost(topt.OffsetParams(**up)))
                  - float(cost(topt.OffsetParams(**dn)))) / (2 * eps)
        ad = float(getattr(g, name)[idx])
        assert np.isfinite(fd) and np.isfinite(ad)
        assert abs(fd - ad) <= atol + rtol * max(abs(fd), abs(ad)), \
            f"{name}[{idx}]: FD {fd} vs AD {ad}"
    return g


def test_fd_vs_grad_conflict_sigmoid_objective():
    """The soft-LoS rollout's gradient in the lateral and time offsets
    against finite differences (ASAS out of the loop; 200 steps, so the
    head-on pairs cross in the horizon): JAX ``tests/test_diff.py``'s
    check on the port."""
    _, tstate, acfg = _pair(4)
    _, cfg = _smooth_cfgs(acfg, False)
    rpz = float(acfg.rpz)

    def cost(p):
        return topt._rollout(topt.apply_offsets(tstate, p, rpz), cfg, 200,
                             50, tobj.ObjectiveWeights(), 0.3, False)[0]
    p = topt.OffsetParams(_t([0.25, -0.15, 0.1, 0.0]),
                          _t([0.05, -0.1, 0.0, 0.0]))
    g = _fd_check(cost, p, [("lateral", 0), ("lateral", 1), ("tshift", 0)])
    assert float(g.lateral[:2].abs().min()) > 0.0


def test_fd_vs_grad_softmin_resolver():
    """The resolver path (sigmoid conflict weights, the softmin solve
    time, the straight-through caps; ASAS in the loop) against finite
    differences in the lateral offsets."""
    _, tstate, acfg = _pair(4)
    _, cfg = _smooth_cfgs(acfg, True)
    rpz = float(acfg.rpz)

    def cost(p):
        return topt._rollout(topt.apply_offsets(tstate, p, rpz), cfg, 40,
                             20, tobj.ObjectiveWeights(), 0.3, False)[0]
    p = topt.OffsetParams(_t([0.2, -0.3, 0.05, 0.0]), _t(np.zeros(4)))
    _fd_check(cost, p, [("lateral", 0), ("lateral", 1)], rtol=2e-2)


def test_perf_clamp_ste():
    """The envelope clamp in the differentiable mode: the forward value
    of the hard clip, the gradient of the identity."""
    from bluesky_tpu_torch.core import perf as perfmod
    _, tstate, _ = _pair(4)

    def allowed(intent, sm):
        return perfmod.limits(tstate.perf, intent, tstate.pilot.vs,
                              tstate.pilot.alt, tstate.ac.ax, smooth=sm)[0]
    intent = torch.full_like(tstate.ac.tas, 500.0, requires_grad=True)
    hard, soft = allowed(intent, None), allowed(intent,
                                                tsmooth.SmoothConfig())
    assert torch.equal(hard, soft)
    g_hard, = torch.autograd.grad(hard.sum(), intent)
    g_soft, = torch.autograd.grad(soft.sum(), intent)
    assert float(g_hard.abs().max()) == 0.0
    assert float(g_soft.abs().min()) > 0.0


# ------------------------------------------------------------ guard words
def test_checked_value_and_grad_words():
    """The guard word of JAX's ``checked_value_and_grad`` on the same
    functions: clean, a non-finite gradient (sqrt at 0), a non-finite
    objective, and a forward step index, which wins."""
    fns = {   # (JAX objective, port objective, forward word, want)
        "clean": (lambda p: jnp.sum(p.lateral ** 2),
                  lambda p: (p.lateral ** 2).sum(), -1, -1),
        "grad": (lambda p: jnp.sum(jnp.sqrt(jnp.abs(p.lateral))),
                 lambda p: p.lateral.abs().sqrt().sum(), -1, -3),
        "value": (lambda p: jnp.sum(p.lateral + jnp.inf),
                  lambda p: (p.lateral + np.inf).sum(), -1, -2),
        "fwd": (lambda p: jnp.sum(p.lateral) + jnp.nan,
                lambda p: p.lateral.sum() + np.nan, 7, 7),
    }
    for name, (fj, ft, fwd, want) in fns.items():
        def jf(p, _s, _t, f=fj, fwd=fwd):
            return f(p), {"bad": jnp.full((), fwd, jnp.int32)}

        def tf(p, _s, _t, f=ft, fwd=fwd):
            return f(p), {"bad": torch.full((), fwd, dtype=torch.int32)}
        _, _, _, bj = jopt.checked_value_and_grad(jf)(
            jopt.OffsetParams(jnp.zeros(3), jnp.zeros(3)), None, 0.0)
        _, _, _, bt = topt.checked_value_and_grad(tf)(
            topt.OffsetParams(torch.zeros(3, dtype=torch.float64),
                              torch.zeros(3, dtype=torch.float64)),
            None, 0.0)
        assert int(bt) == int(bj) == want, name
        assert bt.dtype == torch.int32


def test_poisoned_rollout_guard_matches_jax():
    """A NaN latitude from step 0: both rollouts name the same first bad
    step, and the word wins over the non-finite gradient."""
    jstate, tstate, acfg = _pair(4, leg_km=20.0)
    jstate = jstate.replace(ac=jstate.ac.replace(
        lat=jstate.ac.lat.at[1].set(jnp.nan)))
    tstate.ac.lat[1] = float("nan")
    vg = _jax_value_and_grad(False)
    (vj, badj), gj = vg(jopt.OffsetParams(jnp.zeros(4), jnp.zeros(4)),
                        jstate, jnp.asarray(0.3))
    z = torch.zeros(4, dtype=torch.float64)
    _, _, bad, fwd = _port_value_and_grad(
        tstate, acfg, False, topt.OffsetParams(z, z), 0.3)
    assert int(fwd) == int(badj) == int(bad) == 0


def test_rollout_worlds_match_solo():
    """The rollout of two worlds stacked on the world axis (ASAS in the
    loop, so the [W, N, N] smooth interval runs, and the FMS every other
    step) against each world's solo rollout: the per-world objective and
    the gradients, non-finite entries included."""
    _, tstate, acfg = _pair(4, leg_km=_leg(True))
    _, cfg = _smooth_cfgs(acfg, True)
    rpz = float(acfg.rpz)
    ps = [topt.OffsetParams.from_numpy(_params(4, s), "cpu") for s in (1, 2)]

    def grads(state, p, worlds):
        leaves = [x.clone().requires_grad_() for x in p]
        s = topt.apply_offsets(state, topt.OffsetParams(*leaves), rpz)
        acc, _, bad = topt._rollout(s, cfg, 12, 4, tobj.ObjectiveWeights(),
                                    0.3, worlds)
        g = torch.autograd.grad(acc.sum(), leaves)
        return acc.detach(), g, bad
    wacc, wg, wbad = grads(tstep.stack_worlds([tstate, tstate]),
                           topt.OffsetParams(*[torch.stack(x)
                                               for x in zip(*ps)]), True)
    assert wbad.tolist() == [-1, -1]
    for w, p in enumerate(ps):
        acc, g, _ = grads(tstate, p, False)
        _close("acc", float(wacc[w]), float(acc), 1e-12)
        for a, b in zip(wg, g):
            _close("grad", a[w].numpy(), b.numpy(), 1e-12)
