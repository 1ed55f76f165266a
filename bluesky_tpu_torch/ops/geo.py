"""WGS-84 geodesy on tensors: the part of ``bluesky_tpu/ops/geo.py`` the
simulation uses (local radius, the haversine bearing/distance of the
autopilot, the all-pairs matrices of dense conflict detection with the
reference's radius-at-sum quirk, the dead-reckoning ``qdrpos``, and the
wrapped flat-earth distance of the area and metrics code)."""
import math

import numpy as np
import torch

from . import ties

nm = 1852.0
A_WGS84 = 6378137.0
B_WGS84 = 6356752.314245
REARTH = 6371000.0

_RAD = math.pi / 180.0
_DEG = 180.0 / math.pi


def radians(x):
    return x * _RAD


def degrees(x):
    return x * _DEG


def rwgs84(latd):
    """Local WGS-84 ellipsoid radius [m] at geodetic latitude latd [deg]."""
    lat = radians(latd)
    coslat = torch.cos(lat)
    sinlat = torch.sin(lat)
    an = A_WGS84 * A_WGS84 * coslat
    bn = B_WGS84 * B_WGS84 * sinlat
    ad = A_WGS84 * coslat
    bd = B_WGS84 * sinlat
    return torch.sqrt((an * an + bn * bn) / (ad * ad + bd * bd))


def _mean_radius_scalar(latd1, latd2):
    """Hemisphere-aware mean earth radius (reference geo.py:65-83)."""
    res1 = rwgs84(0.5 * (latd1 + latd2))
    r1 = rwgs84(latd1)
    r2 = rwgs84(latd2)
    denom = torch.abs(latd1) + torch.abs(latd2)
    res2 = 0.5 * (torch.abs(latd1) * (r1 + A_WGS84)
                  + torch.abs(latd2) * (r2 + A_WGS84)) / ties.maximum(
                      denom, 1e-30)
    return torch.where(latd1 * latd2 >= 0.0, res1, res2)


def _mean_radius_matrix(latd1, latd2):
    """Hemisphere-aware radius with the reference *matrix* quirks
    (reference geo.py:117-128): the same-hemisphere radius at ``lat1 +
    lat2`` (not the average) and a 1e-6 deg epsilon in the denominator
    where lat1 == 0."""
    res1 = rwgs84(latd1 + latd2)
    r1 = rwgs84(latd1)
    r2 = rwgs84(latd2)
    eps = torch.where(latd1 == 0.0, 1e-6, 0.0).to(latd1.dtype)
    denom = torch.abs(latd1) + torch.abs(latd2) + eps
    res2 = 0.5 * (torch.abs(latd1) * (r1 + A_WGS84)
                  + torch.abs(latd2) * (r2 + A_WGS84)) / denom
    return torch.where(latd1 * latd2 < 0.0, res2, res1)


def _haversine_qdr_dist(latd1, lond1, latd2, lond2, r):
    """Bearing [deg] and distance [m] given radius r (exact atan2)."""
    lat1 = radians(latd1)
    lon1 = radians(lond1)
    lat2 = radians(latd2)
    lon2 = radians(lond2)
    sin1 = torch.sin(0.5 * (lat2 - lat1))
    sin2 = torch.sin(0.5 * (lon2 - lon1))
    coslat1 = torch.cos(lat1)
    coslat2 = torch.cos(lat2)
    root = sin1 * sin1 + coslat1 * coslat2 * sin2 * sin2
    d = 2.0 * r * torch.atan2(torch.sqrt(root), torch.sqrt(1.0 - root))
    qdr = degrees(torch.atan2(
        torch.sin(lon2 - lon1) * coslat2,
        coslat1 * torch.sin(lat2)
        - torch.sin(lat1) * coslat2 * torch.cos(lon2 - lon1)))
    return qdr, d


def qdrdist(latd1, lond1, latd2, lond2):
    """Bearing [deg] and distance [nm] from pos1 to pos2."""
    r = _mean_radius_scalar(latd1, latd2)
    qdr, d = _haversine_qdr_dist(latd1, lond1, latd2, lond2, r)
    return qdr, d / nm


def latlondist(latd1, lond1, latd2, lond2):
    """Distance [m] between two positions (reference geo.py:165-208)."""
    r = _mean_radius_scalar(latd1, latd2)
    return _haversine_qdr_dist(latd1, lond1, latd2, lond2, r)[1]


def qdrdist_matrix(latd1, lond1, latd2, lond2):
    """All-pairs bearing [deg] / distance [nm], row i from pos1[i], column
    j to pos2[j] (reference geo.py:110-162, with its radius-at-sum
    quirk).  Inputs are 1-D; outputs [len(pos1), len(pos2)]."""
    latd1, lond1 = latd1[..., :, None], lond1[..., :, None]
    latd2, lond2 = latd2[..., None, :], lond2[..., None, :]
    r = _mean_radius_matrix(latd1, latd2)
    qdr, d = _haversine_qdr_dist(latd1, lond1, latd2, lond2, r)
    return qdr, d / nm


def latlondist_matrix(latd1, lond1, latd2, lond2):
    """All-pairs distance [nm] (reference geo.py:211-248, whose code
    returns nm although its docstring says metres)."""
    return qdrdist_matrix(latd1, lond1, latd2, lond2)[1]


def qdrpos(latd1, lond1, qdr, dist):
    """Project a position: start [deg], bearing [deg], distance [nm] ->
    (lat2, lon2) [deg], great-circle dead reckoning on the local WGS-84
    sphere (reference geo.py:263-285)."""
    R = rwgs84(latd1) / nm
    lat1 = radians(latd1)
    lon1 = radians(lond1)
    dr = dist / R
    qdrr = radians(qdr)
    lat2 = torch.asin(torch.sin(lat1) * torch.cos(dr)
                      + torch.cos(lat1) * torch.sin(dr) * torch.cos(qdrr))
    lon2 = lon1 + torch.atan2(torch.sin(qdrr) * torch.sin(dr) * torch.cos(lat1),
                              torch.cos(dr) - torch.sin(lat1) * torch.sin(lat2))
    return degrees(lat2), degrees(lon2)


def kwikdist_wrapped(lata, lona, latb, lonb):
    """Flat-earth distance [nm] with the longitude difference wrapped to
    [-180, 180): on tensors when any argument is one, else in NumPy (the
    host consumers: area circles, sector metrics).  The reference
    ``kwikdist`` is wrong across the antimeridian; this is the JAX
    package's deliberate fix."""
    on_dev = any(isinstance(a, torch.Tensor) for a in (lata, lona, latb, lonb))
    xp = torch if on_dev else np
    rad = radians if on_dev else np.radians
    dlat = rad(latb - lata)
    dlon = rad(((lonb - lona) + 180.0) % 360.0 - 180.0)
    cavelat = xp.cos(rad(lata + latb) * 0.5)
    dangle = xp.sqrt(dlat * dlat + dlon * dlon * cavelat * cavelat)
    return REARTH * dangle / nm
