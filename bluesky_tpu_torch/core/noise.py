"""Noise models: turbulence and the ADS-B transmission model.

Port of ``bluesky_tpu/core/noise.py``.  The random draws come from an
explicit ``torch.Generator``; torch cannot reproduce JAX's threefry
streams, so noise-on runs agree with the JAX package in distribution
only.  Both models are off by default.  In the differentiable mode
(``SimConfig.smooth`` with ``stop_grad_noise``) the draws are detached:
they do not depend on the optimized parameters.
"""
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import aero, geo
from .state import _Struct


class NoiseConfig(NamedTuple):
    """Noise switches/levels (reference SetNoise + SetStandards)."""
    turb_active: bool = False
    turb_sd_hf: float = 1e-6    # [m/s] flight-direction sd
    turb_sd_hw: float = 0.1     # [m/s] wing-direction sd
    turb_sd_vert: float = 0.1   # [m/s] vertical sd
    adsb_transnoise: bool = False
    adsb_truncated: bool = False
    adsb_err_latlon: float = 1e-4          # [deg]
    adsb_err_alt: float = 100.0 * aero.ft  # [m]
    adsb_trunctime: float = 0.0            # [s]


@dataclass
class AdsbArrays(_Struct):
    """Last-broadcast surveillance state."""
    lastupdate: torch.Tensor
    lat: torch.Tensor
    lon: torch.Tensor
    alt: torch.Tensor
    trk: torch.Tensor
    tas: torch.Tensor
    gs: torch.Tensor
    vs: torch.Tensor


def make_adsb(nmax: int, dtype, device) -> AdsbArrays:
    z = lambda: torch.zeros(nmax, dtype=dtype, device=device)
    return AdsbArrays(lastupdate=z(), lat=z(), lon=z(), alt=z(),
                      trk=z(), tas=z(), gs=z(), vs=z())


def _normal(gen, like):
    """Standard normal draws shaped like ``like`` from ``gen``, or, for a
    list of W generators (``core/step.seed_worlds``), the draws of
    each world's aircraft from its own generator, world-major."""
    if isinstance(gen, list):
        n = like.shape[0] // len(gen)
        return torch.cat([torch.randn((n,) + like.shape[1:], generator=g,
                                      dtype=like.dtype, device=like.device)
                          for g in gen])
    return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _detached(smooth, *draws):
    if smooth is not None and smooth.stop_grad_noise:
        return tuple(d.detach() for d in draws)
    return draws


def turbulence_woosh(ac, gen, simdt, cfg: NoiseConfig, smooth=None):
    """Positional turbulence jitter scaled by sqrt(dt)."""
    if not cfg.turb_active:
        return ac
    timescale = simdt ** 0.5
    turbhf, turbhw, turbalt = _detached(
        smooth, _normal(gen, ac.lat) * (cfg.turb_sd_hf * timescale),
        _normal(gen, ac.lat) * (cfg.turb_sd_hw * timescale),
        _normal(gen, ac.lat) * (cfg.turb_sd_vert * timescale))
    trkrad = geo.radians(ac.trk)
    turblat = torch.cos(trkrad) * turbhf - torch.sin(trkrad) * turbhw
    turblon = torch.sin(trkrad) * turbhf + torch.cos(trkrad) * turbhw
    live = ac.active
    return ac.replace(
        alt=torch.where(live, ac.alt + turbalt, ac.alt),
        lat=torch.where(live, ac.lat + geo.degrees(turblat / aero.Rearth),
                        ac.lat),
        lon=torch.where(live, ac.lon + geo.degrees(
            turblon / aero.Rearth / ac.coslat), ac.lon))


def adsb_update(adsb: AdsbArrays, ac, gen, simt: float, cfg: NoiseConfig,
                smooth=None):
    """Refresh broadcast state for aircraft whose truncation window
    elapsed (``simt`` is the host clock, or a tensor of each aircraft's
    world clock)."""
    up = adsb.lastupdate + cfg.adsb_trunctime < simt
    if cfg.adsb_transnoise:
        err1, err2, err3 = _detached(smooth, _normal(gen, ac.lat),
                                     _normal(gen, ac.lat),
                                     _normal(gen, ac.lat))
        lat = ac.lat + err1 * cfg.adsb_err_latlon
        lon = ac.lon + err2 * cfg.adsb_err_latlon
        alt = ac.alt + err3 * cfg.adsb_err_alt
    else:
        lat, lon, alt = ac.lat, ac.lon, ac.alt
    sel = lambda new, old: torch.where(up, new, old)
    return adsb.replace(
        lat=sel(lat, adsb.lat), lon=sel(lon, adsb.lon), alt=sel(alt, adsb.alt),
        trk=sel(ac.trk, adsb.trk), tas=sel(ac.tas, adsb.tas),
        gs=sel(ac.gs, adsb.gs), vs=sel(ac.vs, adsb.vs),
        lastupdate=torch.where(up, adsb.lastupdate + cfg.adsb_trunctime,
                               adsb.lastupdate))
