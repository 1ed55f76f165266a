"""ISA atmosphere, airspeed conversions and geodesy constants
(upstream BlueSky ``tools/aero.py`` and ``tools/geo.py``), elementwise
on tensors of any float dtype."""
import math

import torch

kts = 0.514444          # m/s per knot
ft = 0.3048             # m per foot
fpm = ft / 60.0         # m/s per foot per minute
nm = 1852.0             # m per nautical mile
g0 = 9.80665            # m/s2
R = 287.05287           # J/kg/K, specific gas constant of air
p0 = 101325.0           # Pa
rho0 = 1.225            # kg/m3
T0 = 288.15             # K
Tstrat = 216.65         # K
beta = -0.0065          # K/m
gamma = 1.40
Rearth = 6371000.0      # m, the mean radius of the position update
A_WGS84 = 6378137.0     # m
B_WGS84 = 6356752.314245


def radians(x):
    return x * (math.pi / 180.0)


def degrees(x):
    return x * (180.0 / math.pi)


def vtemp(h):
    return torch.clamp_min(T0 + beta * h, Tstrat)


def vatmos(h):
    """(p [Pa], rho [kg/m3], T [K]) of the two-layer ISA at h [m]."""
    T = vtemp(h)
    rhotrop = rho0 * (T / T0) ** 4.256848030018761
    rho = rhotrop * torch.exp(-torch.clamp_min(h - 11000.0, 0.0)
                              / 6341.552161)
    return rho * R * T, rho, T


def vsound(h):
    return torch.sqrt(gamma * R * vtemp(h))


def vcas2tas(cas, h):
    p, rho, _ = vatmos(h)
    qdyn = p0 * ((1.0 + rho0 * cas * cas / (7.0 * p0)) ** 3.5 - 1.0)
    tas = torch.sqrt(7.0 * p / rho * ((1.0 + qdyn / p) ** (2.0 / 7.0) - 1.0))
    return torch.where(cas < 0, -tas, tas)


def vtas2cas(tas, h):
    p, rho, _ = vatmos(h)
    qdyn = p * ((1.0 + rho * tas * tas / (7.0 * p)) ** 3.5 - 1.0)
    cas = torch.sqrt(7.0 * p0 / rho0 * ((qdyn / p0 + 1.0) ** (2.0 / 7.0)
                                        - 1.0))
    return torch.where(tas < 0, -cas, cas)


def vtas2mach(tas, h):
    return tas / vsound(h)


def vspd2tas(spd, h):
    """TAS of a CAS-or-Mach command value (|spd| < 1 is a Mach)."""
    return torch.where(torch.abs(spd) < 1.0, spd * vsound(h),
                       vcas2tas(spd, h))


def rwgs84(lat_deg):
    """Local WGS-84 radius [m] at a latitude [deg]."""
    lat = radians(lat_deg)
    c, s = torch.cos(lat), torch.sin(lat)
    an, bn = A_WGS84 * A_WGS84 * c, B_WGS84 * B_WGS84 * s
    ad, bd = A_WGS84 * c, B_WGS84 * s
    return torch.sqrt((an * an + bn * bn) / (ad * ad + bd * bd))
