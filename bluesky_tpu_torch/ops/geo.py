"""WGS-84 geodesy on tensors: port of ``bluesky_tpu/ops/geo.py`` (local
radius and gravity, the haversine bearing/distance of the autopilot, the
all-pairs matrices of dense conflict detection with the reference's
radius-at-sum quirk, the dead-reckoning ``qdrpos``, the reference's fast
flat-earth ``kwik*`` family and the wrapped flat-earth distance of the
area and metrics code)."""
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


def wgsg(latd):
    """WGS-84 gravity [m/s2] at latitude latd [deg] (reference
    geo.py:251-260)."""
    geq = 9.7803
    e2 = 6.694e-3
    k = 0.001932
    sinlat = torch.sin(radians(latd))
    return geq * (1.0 + k * sinlat * sinlat) / torch.sqrt(
        1.0 - e2 * sinlat * sinlat)


def _kwik(lata, lona, latb, lonb):
    """``(dlat, dlon, cos of the mean latitude)`` in radians of the flat
    earth of the ``kwik*`` family (reference geo.py:288-382), the
    longitude difference unwrapped as the reference takes it."""
    dlat = radians(latb - lata)
    dlon = radians(lonb - lona)
    cavelat = torch.cos(radians(lata + latb) * 0.5)
    return dlat, dlon, cavelat


def kwikdist(lata, lona, latb, lonb):
    """Fast flat-earth distance [nm] (reference geo.py:288-305; wrong
    across the antimeridian, as the reference is: ``kwikdist_wrapped``
    is the fix)."""
    dlat, dlon, cavelat = _kwik(lata, lona, latb, lonb)
    dangle = torch.sqrt(dlat * dlat + dlon * dlon * cavelat * cavelat)
    return REARTH * dangle / nm


def kwikdist_matrix(lata, lona, latb, lonb):
    """All-pairs fast distance [nm]: row i from a[i], column j to b[j]."""
    return kwikdist(lata[:, None], lona[:, None], latb[None, :],
                    lonb[None, :])


def kwikqdrdist(lata, lona, latb, lonb):
    """Fast flat-earth bearing [deg, 0..360) and distance [m] (the
    reference returns metres here, unlike ``kwikdist``; geo.py:330-344)."""
    dlat, dlon, cavelat = _kwik(lata, lona, latb, lonb)
    dangle = torch.sqrt(dlat * dlat + dlon * dlon * cavelat * cavelat)
    qdr = torch.remainder(degrees(torch.atan2(dlon * cavelat, dlat)), 360.0)
    return qdr, REARTH * dangle


def kwikqdrdist_matrix(lata, lona, latb, lonb):
    """All-pairs fast bearing [deg] and distance [m]."""
    return kwikqdrdist(lata[:, None], lona[:, None], latb[None, :],
                       lonb[None, :])


def kwikpos(latd1, lond1, qdr, dist):
    """Fast flat-earth position projection, ``dist`` in [nm] (reference
    geo.py:365-382)."""
    dx = dist * torch.sin(radians(qdr))
    dy = dist * torch.cos(radians(qdr))
    dlat = dy / 60.0
    dlon = dx / torch.clamp_min(60.0 * torch.cos(radians(latd1)), 0.01)
    return latd1 + dlat, lond1 + dlon


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
