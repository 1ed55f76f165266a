"""The objectives of trajectory optimization.

Port of ``bluesky_tpu/diff/objectives.py``.  Three cost families,
accumulated inside the rollout:

* soft LoS count: the loss-of-separation predicate ``(dist < rpz) &
  (|dalt| < hpz)`` relaxed to a product of sigmoids
  (``smooth.soft_los_weight``) at a temperature the optimizer anneals,
  summed over unique live pairs and steps;
* fuel burn: the per-step integral of the performance model's
  ``fuelflow`` over live aircraft;
* deviation penalty: a quadratic regularizer on the optimized offsets
  in natural units (lateral in protected-zone radii, time shifts in
  ``TSHIFT_SCALE`` seconds).

The hard metrics (``hard_los_count``, ``optimize.hard_los_trace``)
evaluate the exact LoS predicate of ``ops/cd.detect``: optimized plans
are judged by it, never by the relaxation.  Every function takes a
state with a leading world axis too ([W, N] columns) and then returns
one value per world.
"""
from typing import NamedTuple

import torch

from ..ops import geo
from .smooth import soft_los_weight


#: natural scale of the per-aircraft departure-time offsets [s]
TSHIFT_SCALE = 60.0


class ObjectiveWeights(NamedTuple):
    """Objective mix."""
    w_los: float = 1.0       # soft LoS count (the safety term)
    w_fuel: float = 1e-6     # [1/kg] fuel burn
    w_dev: float = 1e-3      # waypoint/time deviation regularizer


def _pair_geometry(ac, eps_m2=1.0):
    """Flat-earth pairwise horizontal distance [m] and altitude gap [m]
    (the small-angle geometry of ``cr_mvp.resume_displacement``);
    ``eps_m2`` keeps the square root's gradient finite on the (masked)
    diagonal."""
    lat, lon = ac.lat, ac.lon
    dist_e = geo.REARTH * (geo.radians(lon[..., None, :] - lon[..., :, None])
                           * torch.cos(0.5 * geo.radians(
                               lat[..., None, :] + lat[..., :, None])))
    dist_n = geo.REARTH * geo.radians(lat[..., None, :] - lat[..., :, None])
    dist = torch.sqrt(dist_e * dist_e + dist_n * dist_n + eps_m2)
    dalt = ac.alt[..., None, :] - ac.alt[..., :, None]
    return dist, dalt


def _pairmask(ac):
    n = ac.lat.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=ac.lat.device)
    return (ac.active[..., :, None] & ac.active[..., None, :]) & ~eye


def soft_los_cost(state, rpz, hpz, temp):
    """Soft (sigmoid) LoS count of one state: the sum over unique live
    pairs of ``soft_los_weight``."""
    dist, dalt = _pair_geometry(state.ac)
    w = soft_los_weight(dist, dalt, rpz, hpz, temp)
    mask = _pairmask(state.ac)
    return 0.5 * torch.where(mask, w, 0.0).sum((-2, -1))


def fuel_cost(state, simdt):
    """Fuel burned this step [kg]: the fuelflow integral over live rows."""
    live = state.ac.active
    return torch.where(live, state.perf.fuelflow, 0.0).sum(-1) * simdt


def step_cost(state, rpz, hpz, weights: ObjectiveWeights, temp, simdt):
    """The per-step objective increment.  ``rpz``/``hpz`` are the soft
    zone sizes: the optimizer inflates them by ``los_margin`` over the
    verification zone, a buffer against the smooth-vs-hard mismatch."""
    c = weights.w_los * soft_los_cost(state, rpz, hpz, temp)
    if weights.w_fuel:
        c = c + weights.w_fuel * fuel_cost(state, simdt)
    return c


def deviation_penalty(lateral_m, tshift_s, rpz, weights: ObjectiveWeights):
    """Quadratic waypoint/time-deviation regularizer in natural units
    (lateral in protected-zone radii, time in ``TSHIFT_SCALE``
    seconds), summed over the last axis."""
    return weights.w_dev * (((lateral_m / rpz) ** 2).sum(-1)
                            + ((tshift_s / TSHIFT_SCALE) ** 2).sum(-1))


# ----------------------------------------------------------- hard metrics
def hard_los_matrix(state, rpz, hpz):
    """The exact LoS predicate of ``ops/cd.detect``'s ``swlos``
    (great-circle pair distance, hard comparisons)."""
    ac = state.ac
    _, distnm = geo.qdrdist_matrix(ac.lat, ac.lon, ac.lat, ac.lon)
    dist = distnm * geo.nm
    dalt = ac.alt[..., None, :] - ac.alt[..., :, None]
    return (dist < rpz) & (torch.abs(dalt) < hpz) & _pairmask(ac)


def hard_los_count(state, rpz, hpz):
    """Directional hard-LoS pair count of one state (int32), counted as
    ``asas.nlos_cur`` is."""
    return hard_los_matrix(state, rpz, hpz).sum((-2, -1), dtype=torch.int32)


def anneal_schedule(temp0, temp1, iters):
    """Geometric temperature annealing schedule (a host list)."""
    if iters <= 1:
        return [float(temp1)]
    r = (float(temp1) / float(temp0)) ** (1.0 / (iters - 1))
    return [float(temp0) * r ** k for k in range(iters)]

