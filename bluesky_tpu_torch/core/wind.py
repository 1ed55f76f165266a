"""Wind field: fixed-capacity point-defined field with altitude profiles.

Port of the device half of ``bluesky_tpu/core/wind.py`` (``WindState``,
``make_windstate``, ``getdata``); adding points is host-side stack
business and comes with the stack port.
"""
from dataclasses import dataclass

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
