"""Trajectory optimization: Adam descent through the chunked step.

Port of ``bluesky_tpu/diff/optimize.py``.  The optimizer descends on
per-aircraft lateral waypoint offsets (meters perpendicular to the
initial track, applied to every route waypoint and the cached active
waypoint) and departure-time offsets (seconds, applied as an
along-track shift of the initial position), with gradients from
``torch.autograd`` through the smooth rollout:

* the rollout is the real step (``core/step.step``) with
  ``SimConfig.smooth`` set (the relaxations of ``diff/smooth.py``),
  chunked, each chunk under ``torch.utils.checkpoint``, so the backward
  pass keeps the chunk-boundary states and recomputes inside one chunk
  at a time.  The recompute makes the same decisions as the forward: a
  step takes its FMS and ASAS gates from the state's host clocks and
  seeds its noise generator from the state's ``rng``, and the chunk
  function takes the whole state;
* the objective (``diff/objectives.py``) accumulates over the steps:
  soft LoS at an annealed temperature, fuel and the deviation penalty;
* the guard word of ``run_steps_checked`` extends over the backward
  pass (``GUARD_BAD_*``): >= 0 is the first non-finite forward step, -2
  a non-finite objective, -3 non-finite gradients; the optimizer halts
  on any trip;
* ``restarts > 1`` stacks R perturbed starts on the world axis and
  steps them with ``core/step.step_worlds``, returning the best.

Optimized plans are verified against the hard metric: the exact
(``smooth=None``) step of the offset-applied state, counting LoS pairs
per step (``hard_los_trace``).  Every function follows the device of the
state it is given.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import graph
from ..core.step import (SimConfig, executor, stack_worlds, state_finite,
                         step, step_worlds)
from ..ops import aero, geo, ties
from . import objectives
from .objectives import ObjectiveWeights, TSHIFT_SCALE
from .smooth import SmoothConfig

#: guard word extensions over run_steps_checked's contract
#: (>= 0 = first bad forward step, -1 = clean):
GUARD_BAD_VALUE = -2     # non-finite objective out of the forward pass
GUARD_BAD_GRADS = -3     # non-finite gradients out of the backward pass


class OffsetParams(NamedTuple):
    """The optimized decision variables, one row per aircraft slot
    ([R, N] with restarts), in normalized units: lateral in
    protected-zone radii, time shifts tanh-bounded to a ±TSHIFT_SCALE
    second departure slot."""
    lateral: torch.Tensor    # [*, N] lateral waypoint offset [rpz units]
    tshift: torch.Tensor     # [*, N] departure-time offset [tanh units]

    def to_numpy(self) -> dict:
        """``{"lateral": array, "tshift": array}``."""
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in self._fields}

    @classmethod
    def from_numpy(cls, tree: dict, device=None):
        """The parameters from ``{"lateral": array, "tshift": array}`` (a
        JAX ``OffsetParams`` moved to numpy, say), bit for bit, on
        ``device`` (CUDA by default)."""
        from ..core.state import resolve_device
        dev = resolve_device(device)
        return cls(*[torch.from_numpy(np.array(tree[k], copy=True)).to(dev)
                     for k in cls._fields])


def tshift_seconds(tshift_param):
    """Effective departure-time offset [s], tanh-squashed: an unbounded
    shift would zero the objective by moving a crossing past the
    horizon, a degenerate optimum."""
    return TSHIFT_SCALE * torch.tanh(tshift_param)


def apply_offsets(state, params: OffsetParams, rpz):
    """Apply the decision variables to a base state, differentiably:
    every route waypoint and the active waypoint shift ``lateral * rpz``
    meters left of the aircraft's track; the position shifts
    ``tshift_seconds(tshift)`` back along the ground velocity (a later
    departure).  Padding rows get no offset."""
    ac = state.ac
    live = ac.active
    lat_m = torch.where(live, params.lateral * rpz, 0.0)
    dt_s = torch.where(live, tshift_seconds(params.tshift), 0.0)

    trkrad = geo.radians(ac.trk)
    tn, te = torch.cos(trkrad), torch.sin(trkrad)
    pn, pe = -te, tn                       # left of track
    coslat = ties.maximum(torch.abs(ac.coslat), 1e-6)
    dlat_wp = geo.degrees(pn * lat_m / aero.Rearth)
    dlon_wp = geo.degrees(pe * lat_m / aero.Rearth / coslat)

    route = state.route.replace(
        wplat=state.route.wplat + dlat_wp[..., None],
        wplon=state.route.wplon + dlon_wp[..., None])
    actwp = state.actwp.replace(lat=state.actwp.lat + dlat_wp,
                                lon=state.actwp.lon + dlon_wp)
    dlat_t = geo.degrees(-dt_s * ac.gsnorth / aero.Rearth)
    dlon_t = geo.degrees(-dt_s * ac.gseast / aero.Rearth / coslat)
    ac = ac.replace(lat=ac.lat + dlat_t, lon=ac.lon + dlon_t)
    return state.replace(ac=ac, route=route, actwp=actwp)


# ------------------------------------------------------------- rollouts
def _rollout(state, cfg: SimConfig, nsteps: int, chunk: int,
             weights: ObjectiveWeights, temp, worlds: bool,
             los_margin: float = 1.0):
    """The chunked, checkpointed objective rollout of ``ceil(nsteps /
    chunk) * chunk`` steps.  Returns ``(cost, final_state, bad)``:
    ``cost`` the accumulated step objective (0-d, or [W] with a world
    axis), ``bad`` the first-bad-step guard word (int32, as
    run_steps_checked, [W] when batched).  Each chunk runs under
    ``torch.utils.checkpoint``: the forward keeps its boundary states
    and the backward recomputes the steps of one chunk at a time.
    ``chunk == nsteps`` checkpoints the whole rollout once."""
    nchunks = max(1, -(-nsteps // chunk))
    stepfn = step_worlds if worlds else step
    rpz_s = cfg.asas.rpz * los_margin    # margin-inflated soft zone
    hpz_s = cfg.asas.hpz

    def chunk_fn(s, acc, bad, i0):
        for i in range(chunk):
            s = stepfn(s, cfg)
            acc = acc + objectives.step_cost(s, rpz_s, hpz_s, weights, temp,
                                             cfg.simdt)
            here = torch.where(state_finite(s), -1, bad.new_full((), i0 + i))
            bad = torch.where(bad >= 0, bad, here)
        return s, acc, bad

    lead = state.ac.lat.shape[:-1]
    acc = torch.zeros(lead, dtype=state.ac.lat.dtype, device=state.device)
    bad = torch.full(lead, -1, dtype=torch.int32, device=state.device)
    for k in range(nchunks):
        # the step draws its noise from a generator of its own, seeded
        # from the state, so the global RNG needs no restoring
        state, acc, bad = checkpoint(chunk_fn, state, acc, bad, k * chunk,
                                     use_reentrant=False,
                                     preserve_rng_state=False)
    return acc, state, bad


def _detached(state):
    return graph.rebuild(state, iter([t.detach()
                                      for _, t in graph.leaves(state)]))


def hard_los_trace(state, cfg: SimConfig, nsteps: int,
                   simdt: Optional[float] = None):
    """Hard-metric verification: step the exact (``smooth=None``) step
    and return ``(max_los, total_los_steps, final_state)``, the peak
    directional LoS pair count over every step and the number of steps
    with any LoS.  Optimized plans are judged by it.

    ``simdt`` re-times the run (default: keep cfg's): the optimizer
    verifies at the serving resolution (0.05 s), where the bang-bang
    dead-bands are tight.  No gradient is taken; on a CUDA state the
    steps replay the chunk runners' CUDA graphs (``core/graph.py``), the
    input state is not written, and the count is kept on the device
    until the end."""
    if simdt is not None:
        nsteps = max(1, int(round(nsteps * cfg.simdt / float(simdt))))
        cfg = cfg._replace(simdt=float(simdt))
    cfg = cfg._replace(smooth=None)
    rpz, hpz = cfg.asas.rpz, cfg.asas.hpz
    with torch.no_grad():
        state = _detached(state)
        ex = executor(state, cfg, keep=True)
        mx = torch.zeros((), dtype=torch.int32, device=state.device)
        tot = torch.zeros_like(mx)
        for _ in range(nsteps):
            ex.step()
            n = objectives.hard_los_count(ex.state, rpz, hpz)
            mx = torch.maximum(mx, n)
            tot = tot + (n > 0)
        final = ex.finish(True)[0]
    return int(mx), int(tot), final


# ------------------------------------------------- checked value_and_grad
def checked_value_and_grad(fn):
    """``fn``'s value and its gradient in the first argument, with the
    integrity-guard word extended over the backward pass.

    ``fn(params, ...) -> (cost, aux)``, ``params`` an ``OffsetParams``,
    ``cost`` a 0-d tensor and ``aux`` a dict carrying the forward guard
    word under ``"bad"``.  Returns ``(value, aux, grads, bad)`` with
    ``bad`` (an int32 0-d tensor):

    * ``>= 0``             the first non-finite forward step (the
                           run_steps_checked contract, unchanged),
    * ``GUARD_BAD_VALUE``  the objective came back non-finite,
    * ``GUARD_BAD_GRADS``  the backward pass gave a non-finite gradient,
    * ``-1``               clean.
    """
    def checked(params, *args, **kwargs):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            value, aux = fn(type(params)(*leaves), *args, **kwargs)
        if value.requires_grad:
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
        else:
            grads = [None] * len(leaves)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        gfinite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        fwd_bad = torch.as_tensor(aux["bad"], device=value.device).max()
        value = value.detach()
        bad = torch.where(
            fwd_bad >= 0, fwd_bad,
            torch.where(~torch.isfinite(value).all(),
                        fwd_bad.new_full((), GUARD_BAD_VALUE),
                        torch.where(~gfinite,
                                    fwd_bad.new_full((), GUARD_BAD_GRADS),
                                    fwd_bad.new_full((), -1))))
        return value, aux, type(params)(*grads), bad.to(torch.int32)

    return checked


# --------------------------------------------------------- the optimizer
class OptResult(NamedTuple):
    lateral_m: np.ndarray       # [N] optimized lateral offsets [m]
    tshift_s: np.ndarray        # [N] optimized time offsets [s]
    objective: list             # per-iteration total objective
    grad_norm: list             # per-iteration gradient 2-norm
    temps: list                 # annealing schedule actually used
    hard_los_before: int        # peak hard LoS pairs, zero offsets
    hard_los_after: int         # peak hard LoS pairs, optimized
    bad: int                    # final guard word (-1 clean)
    iters: int
    nsteps: int
    restarts: int
    best_restart: int

    def to_payload(self, traf_ids=None, slots=None):
        """JSON-able summary (the OPT command's result record)."""
        sl = list(slots) if slots is not None else \
            list(range(len(self.lateral_m)))
        d = {
            "iters": self.iters, "nsteps": self.nsteps,
            "restarts": self.restarts, "best_restart": self.best_restart,
            "objective_first": float(self.objective[0]),
            "objective_last": float(self.objective[-1]),
            "objective_trace": [round(float(v), 6)
                                for v in self.objective],
            "hard_los_before": self.hard_los_before,
            "hard_los_after": self.hard_los_after,
            "bad": self.bad,
            "lateral_m": [round(float(self.lateral_m[s]), 2)
                          for s in sl],
            "tshift_s": [round(float(self.tshift_s[s]), 3) for s in sl],
        }
        if traf_ids is not None:
            d["acid"] = [traf_ids[s] for s in sl]
        return d


def _adam(params, grads, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update, JAX's formula term for term (``torch.optim.Adam``
    rounds differently)."""
    m = type(params)(*[b1 * m_ + (1 - b1) * g for m_, g in zip(m, grads)])
    v = type(params)(*[b2 * v_ + (1 - b2) * g * g
                       for v_, g in zip(v, grads)])
    mh = [m_ / (1 - b1 ** t) for m_ in m]
    vh = [v_ / (1 - b2 ** t) for v_ in v]
    params = type(params)(*[p - lr * m_ / (torch.sqrt(v_) + eps)
                            for p, m_, v_ in zip(params, mh, vh)])
    return params, m, v


def _opt_config(asas_cfg, simdt, with_asas, smooth):
    """The rollout's configuration: dense, smooth, ASAS in the loop only
    with ``with_asas``."""
    from ..core.asas import AsasConfig
    asas_cfg = asas_cfg if asas_cfg is not None else AsasConfig()
    opt_asas = asas_cfg if with_asas else asas_cfg._replace(swasas=False)
    return asas_cfg, SimConfig(simdt=float(simdt), asas=opt_asas,
                               cd_backend="dense",
                               smooth=smooth or SmoothConfig())


def init_offsets(state, *, restarts: int = 1, seed: int = 0,
                 init_noise: float = 0.1) -> OffsetParams:
    """The start of the descent: lateral offsets of ``init_noise`` rpz
    of seeded normal noise (drawn on the CPU, so every device starts
    from the same numbers), widened 1x to 3x across restarts; zero time
    shifts.  The jitter is required: an exactly head-on pair sits on a
    symmetry saddle of the soft-LoS objective, where the lateral
    gradient is 0."""
    nmax = state.ac.lat.shape[-1]
    dtype = state.ac.lat.dtype
    shape = (restarts, nmax) if restarts > 1 else (nmax,)
    gen = torch.Generator().manual_seed(int(seed))
    lat0 = init_noise * torch.randn(shape, generator=gen, dtype=dtype)
    if restarts > 1:
        lat0 = lat0 * torch.linspace(1.0, 3.0, restarts, dtype=dtype)[:, None]
    return OffsetParams(lat0.to(state.device),
                        torch.zeros(shape, dtype=dtype, device=state.device))


def optimize(state, asas_cfg=None, *, restarts: int = 1, seed: int = 0,
             init_noise: float = 0.1, **kw) -> OptResult:
    """Descend on waypoint/time offsets until the annealed soft-LoS
    objective is minimized, then verify against the hard metric.

    ``state`` is a single-world state (``sim.traf.state`` at OPT time).
    The rollout runs the smooth step at ``simdt`` (coarser than the
    serving 0.05 s); ASAS stays out of the loop unless ``with_asas``
    (then the descent goes through the smooth MVP resolver).
    ``restarts > 1`` runs R perturbed starts on the world axis and
    returns the best.  The other keywords are ``descend``'s."""
    params0 = init_offsets(state, restarts=restarts, seed=seed,
                           init_noise=init_noise)
    return descend(state, params0, asas_cfg, **kw)


def descend(state, params0: OffsetParams, asas_cfg=None, *,
            tend: float = 600.0, simdt: float = 1.0, chunk: int = 50,
            iters: int = 60, lr: float = 0.15, temp0: float = 0.3,
            temp1: float = 0.05, weights: Optional[ObjectiveWeights] = None,
            smooth: Optional[SmoothConfig] = None, with_asas: bool = False,
            opt_tshift: bool = True, los_margin: float = 1.2,
            verify_simdt: float = 0.05, verbose=None) -> OptResult:
    """The descent of ``optimize`` from the given start ``params0`` ([N],
    or [R, N] for R restarts on the world axis)."""
    weights = weights or ObjectiveWeights()
    asas_cfg, cfg = _opt_config(asas_cfg, simdt, with_asas, smooth)
    rpz = float(asas_cfg.rpz)
    nsteps = max(1, int(round(float(tend) / float(simdt))))
    chunk = max(1, min(int(chunk), nsteps))
    nsteps = -(-nsteps // chunk) * chunk     # whole chunks
    iters = max(1, int(iters))               # 0 iters has no iterate
    restarts = params0.lateral.shape[0] if params0.lateral.ndim == 2 else 1
    worlds = restarts > 1
    nmax = state.ac.lat.shape[-1]
    dtype = state.ac.lat.dtype
    base = stack_worlds([state] * restarts) if worlds else state

    def cost_fn(params, bstate, temp):
        pl = params.lateral
        pt = params.tshift if opt_tshift else params.tshift.detach()
        s = apply_offsets(bstate, OffsetParams(pl, pt), rpz)
        dev = objectives.deviation_penalty(pl * rpz, tshift_seconds(pt), rpz,
                                           weights)
        acc, _final, bad = _rollout(s, cfg, nsteps, chunk, weights, temp,
                                    worlds, los_margin=los_margin)
        per = acc + dev                      # 0-d or [W]
        return per.sum(), {"per_restart": per, "bad": bad}

    vgc = checked_value_and_grad(cost_fn)
    params = OffsetParams(*[p.to(device=state.device, dtype=dtype)
                            for p in params0])
    m = OffsetParams(*[torch.zeros_like(p) for p in params])
    v = OffsetParams(*[torch.zeros_like(p) for p in params])

    temps = objectives.anneal_schedule(temp0, temp1, iters)
    from ..obs.trace import get_recorder
    rec = get_recorder()
    trace, gnorms = [], []
    bad_word = -1
    per = None
    for it in range(iters):
        # on a guard trip the Adam update has folded the non-finite
        # gradients into the new iterate: keep the one before it
        params_prev = params
        with rec.span("opt_step", cat="opt", it=it, restarts=restarts,
                      nsteps=nsteps):
            # the temperature rounded to the state's dtype
            temp = float(torch.tensor(temps[it], dtype=dtype))
            value, aux, grads, bad = vgc(params, base, temp)
            per = aux["per_restart"].detach()
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            params, m, v = _adam(params, grads, m, v, it + 1, lr)
            bad_word = int(bad)
        trace.append(float(value))
        gnorms.append(float(gnorm))
        if verbose:
            verbose(it, trace[-1], gnorms[-1], bad_word)
        if bad_word != -1:
            params = params_prev       # guard trip: halt the descent
            break

    per = per.cpu().numpy()
    best = int(np.argmin(per)) if worlds else 0
    bp = OffsetParams(*[(p[best] if worlds else p).detach().cpu().numpy()
                        for p in params])
    active = state.ac.active.cpu().numpy()
    lateral_m = np.where(active, bp.lateral * rpz, 0.0)
    tshift_s = np.where(active & opt_tshift,
                        TSHIFT_SCALE * np.tanh(bp.tshift), 0.0)

    # hard-metric verification of the zero-offset and optimized plans
    with torch.no_grad():
        zerop = OffsetParams(*[torch.zeros(nmax, dtype=dtype,
                                           device=state.device)] * 2)
        los_before, _, _ = hard_los_trace(
            apply_offsets(state, zerop, rpz), cfg, nsteps,
            simdt=verify_simdt)
        optp = OffsetParams(*[torch.as_tensor(a, dtype=dtype,
                                              device=state.device) for a in (
            lateral_m / rpz,
            np.arctanh(np.clip(tshift_s / TSHIFT_SCALE, -0.999999,
                               0.999999)))])
        los_after, _, _ = hard_los_trace(
            apply_offsets(state, optp, rpz), cfg, nsteps,
            simdt=verify_simdt)

    return OptResult(
        lateral_m=lateral_m, tshift_s=tshift_s, objective=trace,
        grad_norm=gnorms, temps=temps[:len(trace)],
        hard_los_before=los_before, hard_los_after=los_after,
        bad=bad_word, iters=len(trace), nsteps=nsteps,
        restarts=restarts, best_restart=best)


def value_and_grad_once(state, asas_cfg=None, *, tend: float = 600.0,
                        simdt: float = 1.0, chunk: int = 50,
                        temp: float = 1.0,
                        weights: Optional[ObjectiveWeights] = None,
                        smooth: Optional[SmoothConfig] = None,
                        with_asas: bool = False, los_margin: float = 1.2):
    """One checked value and gradient of the rollout objective at zero
    offsets.  Returns ``(value, grads, bad)`` as tensors on the state's
    device."""
    weights = weights or ObjectiveWeights()
    asas_cfg, cfg = _opt_config(asas_cfg, simdt, with_asas, smooth)
    rpz = float(asas_cfg.rpz)
    nsteps = max(1, int(round(float(tend) / float(simdt))))
    chunk = max(1, min(int(chunk), nsteps))

    def cost_fn(p, bstate, t):
        s = apply_offsets(bstate, p, rpz)
        acc, _, bad = _rollout(s, cfg, nsteps, chunk, weights, t, False,
                               los_margin=los_margin)
        return acc, {"bad": bad}

    z = torch.zeros(state.ac.lat.shape[-1], dtype=state.ac.lat.dtype,
                    device=state.device)
    temp = float(torch.tensor(temp, dtype=state.ac.lat.dtype))
    value, _aux, grads, bad = checked_value_and_grad(cost_fn)(
        OffsetParams(z, z), state, temp)
    return value, grads, bad


def grad_once(state, asas_cfg=None, **kw):
    """One checked value_and_grad evaluation at zero offsets (the GRAD
    stack command; keywords of ``value_and_grad_once``): returns
    ``(objective, grad_norm, bad)`` as host numbers."""
    value, grads, bad = value_and_grad_once(state, asas_cfg, **kw)
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    return float(value), gnorm, int(bad)


# --------------------------------------------------------------- scenes
def conflict_scene(n_ac: int = 50, *, leg_km: float = 60.0,
                   pair_spacing_km: float = 80.0, alt_m: float = 8000.0,
                   spd_ms: float = 240.0, lat0: float = 48.0,
                   lon0: float = 4.0, nmax: Optional[int] = None,
                   dtype=None, wmax: int = 8, device=None, traf=None):
    """A guaranteed-conflict scene: ``n_ac // 2`` head-on pairs on an
    east-west axis, the pairs stacked north-south far enough apart that
    only partners conflict.  Each aircraft files one waypoint at its
    partner's start (LNAV direct), so with zero offsets each pair meets
    nose to nose at its midpoint: the 50-aircraft demo scene that
    gradient descent must deconflict to zero hard LoS.

    Returns ``(traf, asas_cfg)``: a new ``Traffic`` on ``device`` (CUDA
    by default), or ``traf`` (a Simulation's, say) with the scene
    created in it, whose state is ready to roll out.
    """
    from ..core.asas import AsasConfig
    from ..core.traffic import Traffic

    n_pairs = max(1, n_ac // 2)
    n = 2 * n_pairs
    dlat_pair = pair_spacing_km / 111.0
    dlon_leg = leg_km / 111.0     # not cos-corrected: the scene's scale
    #                               only needs to be approximate
    lats, lons, hdgs = [], [], []
    for k in range(n_pairs):
        plat = lat0 + k * dlat_pair
        lats += [plat, plat]
        lons += [lon0 - dlon_leg, lon0 + dlon_leg]
        hdgs += [90.0, 270.0]
    if traf is None:
        traf = Traffic(nmax=nmax or n, wmax=wmax,
                       dtype=dtype or torch.float32, pair_matrix=True,
                       device=device)
    traf.create(n, "B744", alt_m, spd_ms, None,
                np.asarray(lats), np.asarray(lons), np.asarray(hdgs),
                acid=[f"OPT{i:03d}" for i in range(n)])
    traf.flush()

    # single-waypoint LNAV-direct routes to the partner's start
    st = traf.state
    dev = st.device
    partner = np.arange(n) ^ 1
    plats = np.asarray(lats)[partner]
    plons = np.asarray(lons)[partner]
    wplat = st.route.wplat.clone()
    wplon = st.route.wplon.clone()
    wplat[:n, 0] = torch.as_tensor(plats, dtype=wplat.dtype, device=dev)
    wplon[:n, 0] = torch.as_tensor(plons, dtype=wplon.dtype, device=dev)
    nwp = st.route.nwp.clone()
    nwp[:n] = 1
    aw_lat = st.actwp.lat.clone()
    aw_lon = st.actwp.lon.clone()
    aw_lat[:n] = torch.as_tensor(plats, dtype=aw_lat.dtype, device=dev)
    aw_lon[:n] = torch.as_tensor(plons, dtype=aw_lon.dtype, device=dev)
    lnav = torch.zeros_like(st.ac.swlnav)
    lnav[:n] = True
    traf.state = st.replace(
        route=st.route.replace(
            wplat=wplat, wplon=wplon, nwp=nwp,
            iactwp=torch.where(lnav, 0, st.route.iactwp)),
        actwp=st.actwp.replace(lat=aw_lat, lon=aw_lon),
        ac=st.ac.replace(swlnav=lnav,
                         swvnav=torch.zeros_like(st.ac.swvnav)))
    return traf, AsasConfig()
