"""Relaxations of the step's hard gates for the differentiable rollout.

Port of ``bluesky_tpu/diff/smooth.py``.  ``SimConfig.smooth``
(``core/step.py``) carries a ``SmoothConfig``, or ``None``, the default,
with which every call site takes its hard code path and the step is
the serving step bit for bit.  The relaxations:

1. the conflict predicate ``swconfl`` of ``ops/cd.detect`` becomes a
   product of sigmoids on the same margins (``soft_conflict_weight``),
   which weights the MVP pair contributions;
2. MVP's per-ownship minimum solve time becomes a weighted softmin
   (``softmin_weighted``);
3. the performance-envelope and resolver caps become straight-through
   clips (``ste_clip``: the forward value of the clip, the gradient of
   the identity);
4. the bang-bang captures of ``core/kinematics.update_airspeed`` become
   clipped proportional steps (``capture_step``);
5. the noise draws are detached (they do not depend on the optimized
   parameters).

A clip here is JAX's ``jnp.clip``, whose gradient at a bound is 0.5
(``ops/ties.py``).  Temperatures are part of the configuration; the
soft-LoS objective anneals a temperature of its own (``objectives.py``).
"""
from typing import NamedTuple

import torch

from ..ops import ties


class SmoothConfig(NamedTuple):
    """Relaxation temperatures.  ``temp_conf`` scales the conflict
    sigmoids in units of the natural margin (rpz² for the CPA distance,
    the lookahead for the times); ``temp_min`` is the softmin sharpness
    in units of the lookahead."""
    temp_conf: float = 0.1     # conflict sigmoid temperature [x margin]
    temp_min: float = 0.05     # softmin temperature [x tlookahead]
    ste_caps: bool = True      # straight-through resolver/perf clamps
    stop_grad_noise: bool = True  # detach the noise draws


def sigmoid(x):
    return torch.sigmoid(x)


def ste_clip(x, lo, hi):
    """Straight-through clip: forward ``jnp.clip(x, lo, hi)``, backward
    the identity."""
    return x + (ties.clip(x, lo, hi) - x).detach()


def softmin_weighted(x, w, temp, big=1e9):
    """Weighted softmin over the last axis, the smooth stand-in for
    ``min(where(mask, x, big))``: ``w`` in [0, 1] are the pair weights
    (entries with ``w == 0`` drop out as masked entries of the hard min
    do), ``temp`` the temperature in ``x``'s units.  A row with no
    weight returns ``big``; ``temp -> 0`` gives the hard masked min."""
    xe = torch.where(w > 0.0, x, big)
    xmin = xe.amin(-1, keepdim=True)
    e = w * torch.exp(-(xe - xmin) / temp)
    den = e.sum(-1)
    num = (e * xe).sum(-1)
    return torch.where(den > 1e-30, num / ties.maximum(den, 1e-30),
                       xmin.squeeze(-1))


def softmax_weighted(x, w, temp, big=1e9):
    """Weighted softmax over the last axis, the dual of
    ``softmin_weighted``."""
    return -softmin_weighted(-x, w, temp, big=big)


def soft_conflict_weight(cd, rpz, tlookahead, smooth: SmoothConfig):
    """Sigmoid relaxation of the hard conflict predicate of
    ``ops/cd.detect`` (``swhorconf & (tin <= tout) & (tout > 0) & (tin <
    tlookahead) & pairmask``) on the same CPA geometry: the CPA miss
    distance against rpz² (scale ``temp_conf * rpz²``), the window times
    against the lookahead (scale ``temp_conf * tlookahead``).  Masked and
    diagonal pairs carry the detect's 1e9 offsets, which drive their
    weight to exactly 0.  Returns the [N, N] weights in [0, 1]."""
    r2 = rpz * rpz
    th = smooth.temp_conf * r2
    tt = smooth.temp_conf * tlookahead
    w = sigmoid((r2 - cd.dcpa2) / th)
    w = w * sigmoid((cd.toutconf - cd.tinconf) / tt)
    w = w * sigmoid(cd.toutconf / tt)
    w = w * sigmoid((tlookahead - cd.tinconf) / tt)
    return w


def soft_los_weight(dist, dalt, rpz, hpz, temp):
    """Sigmoid relaxation of the LoS predicate ``(dist < rpz) & (|dalt| <
    hpz)``; ``temp`` (a number or a 0-d tensor, annealed by the
    optimizer) is a fraction of the zone size."""
    wh = sigmoid((rpz - dist) / (temp * rpz))
    wv = sigmoid((hpz - torch.abs(dalt)) / (temp * hpz))
    return wh * wv


def capture_step(error, max_step):
    """Relaxed bang-bang capture: the full-rate step toward the target,
    saturating exactly at the error, with a straight-through backward
    (``max_step`` = rate * dt >= 0)."""
    return ste_clip(error, -max_step, max_step)
