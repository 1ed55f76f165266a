"""WGS-84 geodesy on tensors: the part of ``bluesky_tpu/ops/geo.py`` the
simulation step uses (local radius and the haversine bearing/distance of
the autopilot)."""
import math

import torch

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
                  + torch.abs(latd2) * (r2 + A_WGS84)) / torch.clamp_min(
                      denom, 1e-30)
    return torch.where(latd1 * latd2 >= 0.0, res1, res2)


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
