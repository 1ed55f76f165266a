"""Wind field: fixed-capacity point-defined field with altitude profiles.

Port of ``bluesky_tpu/core/wind.py``: ``WindState``, ``make_windstate``,
``add_point`` (the host side of the WIND command) and ``getdata``.
"""
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import aero, geo
from .state import _Struct

ALTMAX = 45000.0 * aero.ft
ALTSTEP = 100.0 * aero.ft
KALT = int(ALTMAX / ALTSTEP) + 1


@dataclass
class WindState(_Struct):
    """Fixed-capacity wind field (device side)."""
    lat: torch.Tensor      # [P] deg
    lon: torch.Tensor      # [P] deg
    vnorth: torch.Tensor   # [P,K] m/s on the fixed altitude axis
    veast: torch.Tensor    # [P,K] m/s
    active: torch.Tensor   # [P] bool
    winddim: torch.Tensor  # scalar int: 0 none, 1 const, 2 planar, 3 profiles


def make_windstate(pmax: int = 16, dtype=torch.float32,
                   device=None) -> WindState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return WindState(
        lat=z(pmax), lon=z(pmax), vnorth=z(pmax, KALT), veast=z(pmax, KALT),
        active=torch.zeros(pmax, dtype=torch.bool, device=device),
        winddim=torch.zeros((), dtype=torch.int32, device=device))


def add_point(wind: WindState, lat, lon, winddir, windspd,
              windalt=None) -> WindState:
    """Write a wind point into the first free slot, in place; returns
    ``wind``.

    winddir [deg] is the direction the wind comes FROM (the +pi in
    reference windfield.py:84-92 converts to the blow-to vector).
    windspd [m/s].  With ``windalt`` (list), dir/spd are arrays per
    altitude, linearly resampled onto the fixed axis."""
    altaxis = np.arange(0.0, KALT) * ALTSTEP
    if windalt is None:
        wdir = np.full(KALT, float(np.atleast_1d(winddir)[0]))
        wspd = np.full(KALT, float(np.atleast_1d(windspd)[0]))
        vn = wspd * np.cos(np.radians(wdir) + np.pi)
        ve = wspd * np.sin(np.radians(wdir) + np.pi)
        prof3d = False
    else:
        wdir = np.asarray(winddir, dtype=float)
        wspd = np.asarray(windspd, dtype=float)
        altvn = wspd * np.cos(np.radians(wdir) + np.pi)
        altve = wspd * np.sin(np.radians(wdir) + np.pi)
        vn = np.interp(altaxis, np.asarray(windalt, dtype=float), altvn)
        ve = np.interp(altaxis, np.asarray(windalt, dtype=float), altve)
        prof3d = True

    active = wind.active.cpu().numpy()
    free = np.flatnonzero(~active)
    if len(free) == 0:
        raise ValueError("wind field full; increase pmax")
    i = int(free[0])
    nactive = int(active.sum()) + 1
    winddim = int(wind.winddim)
    if winddim < 3:
        winddim = min(2, nactive)
    if prof3d:
        winddim = 3
    row = lambda a, v: torch.as_tensor(v, dtype=a.dtype, device=a.device)
    wind.lat[i] = float(lat)
    wind.lon[i] = float(lon)
    wind.vnorth[i] = row(wind.vnorth, vn)
    wind.veast[i] = row(wind.veast, ve)
    wind.active[i] = True
    wind.winddim.fill_(winddim)
    return wind


def getdata(wind: WindState, lat, lon, alt):
    """Wind (vnorth, veast) [m/s] at positions: inverse-distance-squared
    horizontal weights over active points, linear in altitude; zeros
    when no points are defined."""
    eps = 1e-20
    cavelat = torch.cos(geo.radians(0.5 * (lat[None, :] + wind.lat[:, None])))
    dy = lat[None, :] - wind.lat[:, None]
    dx = cavelat * (lon[None, :] - wind.lon[:, None])
    invd2 = wind.active[:, None] / (eps + dx * dx + dy * dy)    # [P, N]
    total = torch.clamp_min(invd2.sum(0, keepdim=True), 1e-30)
    horfact = invd2 / total

    idxalt = torch.clamp(alt, max=ALTMAX - 1e-6).clamp_min(0.0) / ALTSTEP
    ialt = torch.floor(idxalt).to(torch.int64)
    falt = idxalt - ialt
    ihi = torch.clamp_max(ialt + 1, KALT - 1)
    vnT, veT = wind.vnorth.T, wind.veast.T
    w = horfact.T                                               # [N, P]
    vnorth = (1.0 - falt) * (vnT[ialt] * w).sum(1) \
        + falt * (vnT[ihi] * w).sum(1)
    veast = (1.0 - falt) * (veT[ialt] * w).sum(1) \
        + falt * (veT[ihi] * w).sum(1)
    haswind = wind.winddim > 0
    return (torch.where(haswind, vnorth, torch.zeros_like(vnorth)),
            torch.where(haswind, veast, torch.zeros_like(veast)))
