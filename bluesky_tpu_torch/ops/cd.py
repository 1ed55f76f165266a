"""State-based conflict detection as one all-pairs broadcast on tensors.

Port of ``bluesky_tpu/ops/cd.py``: the pairwise bearing/distance on the
WGS-84 mean-radius sphere (with the reference's matrix quirk), the
closest point of approach from the relative velocity, the horizontal
entry/exit times, the vertical crossing times and the combined conflict
predicate within the lookahead (reference StateBasedCD.py:7-103).  The
CD of ``SimConfig(cd_backend="dense")``; every pair matrix is
``[N, N]``, so it suits fleets up to ~16k aircraft.  The diagonal and
the padding slots are excluded with a 1e9 offset on distance, tcpa and
altitude difference plus a hard mask on the flags, so the numerics of
real pairs are untouched.  No kernel: the JAX function is one XLA
broadcast, and this is the same broadcast in eager PyTorch.
"""
from typing import NamedTuple

import numpy as np
import torch

from . import geo, ties


class ConflictData(NamedTuple):
    """Conflict-detection output; pair matrices are [ownship i, intruder
    j], garbage (masked large values) where ``swconfl`` is False."""
    swconfl: torch.Tensor   # [N, N] bool  conflict pair flag (directional)
    swlos: torch.Tensor     # [N, N] bool  loss-of-separation flag
    inconf: torch.Tensor    # [N]    bool  ownship in conflict
    tcpamax: torch.Tensor   # [N]          max tcpa over the conflicts
    qdr: torch.Tensor       # [N, N] deg   bearing i -> j
    dist: torch.Tensor      # [N, N] m     distance (masked + 1e9)
    dcpa2: torch.Tensor     # [N, N] m2    separation squared at CPA
    tcpa: torch.Tensor      # [N, N] s     time to CPA (masked + 1e9)
    tinconf: torch.Tensor   # [N, N] s     conflict entry time
    toutconf: torch.Tensor  # [N, N] s     conflict exit time


def detect(lat, lon, trk, gs, alt, vs, active, rpz, hpz, tlookahead):
    """All-pairs state-based conflict detection of the [N] columns
    (position [deg], track [deg], ground speed [m/s], altitude [m],
    vertical speed [m/s], ``active`` bool) with protected zone ``rpz``
    [m] / ``hpz`` [m] and lookahead [s].  Returns a ``ConflictData``."""
    n = lat.shape[-1]
    dt = lat.dtype
    eye = torch.eye(n, dtype=torch.bool, device=lat.device)
    pairmask = (active[..., :, None] & active[..., None, :]) & ~eye
    zero = torch.zeros((), dtype=dt, device=lat.device)
    excl = torch.where(pairmask, zero, zero + 1e9)

    # Horizontal geometry
    qdr, distnm = geo.qdrdist_matrix(lat, lon, lat, lon)
    dist = distnm * geo.nm + excl
    qdrrad = geo.radians(qdr)
    dx = dist * torch.sin(qdrrad)
    dy = dist * torch.cos(qdrrad)

    trkrad = geo.radians(trk)
    u = gs * torch.sin(trkrad)
    v = gs * torch.cos(trkrad)
    du = u[..., None, :] - u[..., :, None]
    dv = v[..., None, :] - v[..., :, None]
    dv2 = du * du + dv * dv
    dv2 = torch.where(torch.abs(dv2) < 1e-6, zero + 1e-6, dv2)
    vrel = torch.sqrt(dv2)

    tcpa = -(du * dx + dv * dy) / dv2 + excl
    dcpa2 = dist * dist - tcpa * tcpa * dv2
    r2 = rpz * rpz
    swhorconf = dcpa2 < r2
    dtinhor = torch.sqrt(ties.maximum(r2 - dcpa2, 0.0)) / vrel
    tinhor = torch.where(swhorconf, tcpa - dtinhor, zero + 1e8)
    touthor = torch.where(swhorconf, tcpa + dtinhor, zero - 1e8)

    # Vertical geometry: dalt[i, j] = alt[j] - alt[i]
    dalt = alt[..., None, :] - alt[..., :, None] + excl
    dvs = vs[..., None, :] - vs[..., :, None]
    dvs = torch.where(torch.abs(dvs) < 1e-6, zero + 1e-6, dvs)
    tcrosshi = (dalt + hpz) / -dvs
    tcrosslo = (dalt - hpz) / -dvs
    tinver = torch.minimum(tcrosshi, tcrosslo)
    toutver = torch.maximum(tcrosshi, tcrosslo)

    tinconf = torch.maximum(tinver, tinhor)
    toutconf = torch.minimum(toutver, touthor)
    swconfl = (swhorconf & (tinconf <= toutconf) & (toutconf > 0.0)
               & (tinconf < tlookahead) & pairmask)
    inconf = swconfl.any(-1)
    # JAX's max of ``tcpa * swconfl`` drops the NaN of a pair with a
    # non-finite aircraft (XLA's reduce-max); torch's amax would return
    # it on every row.  Such a pair is never in conflict, so masking
    # before the max gives JAX's rows.
    tcpamax = torch.where(swconfl, tcpa, torch.zeros_like(tcpa)).amax(-1)
    swlos = (dist < rpz) & (torch.abs(dalt) < hpz) & pairmask
    return ConflictData(swconfl=swconfl, swlos=swlos, inconf=inconf,
                        tcpamax=tcpamax, qdr=qdr, dist=dist, dcpa2=dcpa2,
                        tcpa=tcpa, tinconf=tinconf, toutconf=toutconf)


def pairs_from_mask(mask, ids):
    """Host helper: ``[(id_i, id_j), ...]`` of a boolean pair matrix in
    row-major order, as the reference's ``zip(*np.where(swconfl))``
    (StateBasedCD.py:93-95); ``ids`` is the host list of callsigns."""
    rows, cols = np.nonzero(mask.detach().cpu().numpy())
    return [(ids[i], ids[j]) for i, j in zip(rows, cols)]
