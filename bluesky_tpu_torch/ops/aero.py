"""ISA atmosphere and airspeed conversions on tensors.

Port of ``bluesky_tpu/ops/aero.py`` (reference ``bluesky/tools/aero.py``
vectorized ``v*`` family): two-layer ISA, CAS/TAS/EAS/Mach conversions,
the crossover-aware ``vcasormach`` and the crossover altitude.  Elementwise, any float dtype.
"""
import math

import torch

from . import ties

kts = 0.514444          # m/s per knot
ft = 0.3048             # m per foot
fpm = ft / 60.0         # m/s per foot-per-minute
inch = 0.0254
sqft = 0.09290304
nm = 1852.0             # m per nautical mile
lbs = 0.453592          # kg per pound
g0 = 9.80665            # m/s2
R = 287.05287           # J/kg/K specific gas constant of air
p0 = 101325.0           # Pa sea-level ISA pressure
rho0 = 1.225            # kg/m3 sea-level ISA density
T0 = 288.15             # K sea-level ISA temperature
Tstrat = 216.65         # K stratosphere temperature
gamma = 1.40
gamma1 = 0.2            # (gamma-1)/2
gamma2 = 3.5            # gamma/(gamma-1)
beta = -0.0065          # K/m tropospheric lapse rate
Rearth = 6371000.0      # m mean earth radius
a0 = math.sqrt(gamma * R * T0)  # sea-level speed of sound


def vtemp(h):
    """ISA temperature [K] at altitude h [m]."""
    return ties.maximum(T0 + beta * h, Tstrat)


def vatmos(h):
    """ISA pressure [Pa], density [kg/m3], temperature [K] at h [m]."""
    T = vtemp(h)
    rhotrop = rho0 * (T / T0) ** 4.256848030018761
    dhstrat = ties.maximum(h - 11000.0, 0.0)
    rho = rhotrop * torch.exp(-dhstrat / 6341.552161)  # = g0/(R*Tstrat)
    p = rho * R * T
    return p, rho, T


def vpressure(h):
    return vatmos(h)[0]


def vdensity(h):
    return vatmos(h)[1]


def vvsound(h):
    """Speed of sound [m/s] at altitude h [m]."""
    return torch.sqrt(gamma * R * vtemp(h))


def vtas2mach(tas, h):
    return tas / vvsound(h)


def vmach2tas(M, h):
    return M * vvsound(h)


def veas2tas(eas, h):
    return eas * torch.sqrt(rho0 / vdensity(h))


def vtas2eas(tas, h):
    return tas * torch.sqrt(vdensity(h) / rho0)


def vcas2tas(cas, h):
    """CAS -> TAS [m/s] via compressible-flow dynamic pressure."""
    p, rho, _ = vatmos(h)
    qdyn = p0 * ((1.0 + rho0 * cas * cas / (7.0 * p0)) ** 3.5 - 1.0)
    tas = torch.sqrt(7.0 * p / rho * ((1.0 + qdyn / p) ** (2.0 / 7.0) - 1.0))
    return torch.where(cas < 0, -tas, tas)


def vtas2cas(tas, h):
    """TAS -> CAS [m/s]."""
    p, rho, _ = vatmos(h)
    qdyn = p * ((1.0 + rho * tas * tas / (7.0 * p)) ** 3.5 - 1.0)
    cas = torch.sqrt(7.0 * p0 / rho0 * ((qdyn / p0 + 1.0) ** (2.0 / 7.0) - 1.0))
    return torch.where(tas < 0, -cas, cas)


def vmach2cas(M, h):
    return vtas2cas(vmach2tas(M, h), h)


def vcas2mach(cas, h):
    return vtas2mach(vcas2tas(cas, h), h)


def vcasormach(spd, h):
    """Interpret spd as Mach if 0.1 < spd < 1 else as CAS [m/s].

    Returns (tas, cas, mach)."""
    ismach = (0.1 < spd) & (spd < 1.0)
    tas = torch.where(ismach, vmach2tas(spd, h), vcas2tas(spd, h))
    cas = torch.where(ismach, vtas2cas(tas, h), spd)
    m = torch.where(ismach, spd, vtas2mach(tas, h))
    return tas, cas, m


def vcasormach2tas(spd, h):
    """TAS from a CAS-or-Mach command value (|spd| < 1 => Mach)."""
    return torch.where(torch.abs(spd) < 1.0, vmach2tas(spd, h),
                       vcas2tas(spd, h))


def crossoveralt(cas, mach):
    """Crossover altitude [m] where the CAS ``cas`` [m/s] and the Mach
    ``mach`` give the same speed: the standard ISA relation in the
    troposphere (JAX ``ops/aero.py``)."""
    # impact pressure ratio at sea level for the CAS
    dp = (1.0 + gamma1 * (cas / a0) ** 2) ** gamma2 - 1.0
    # the pressure ratio at which that impact pressure gives the Mach
    pratio = dp / ((1.0 + gamma1 * mach * mach) ** gamma2 - 1.0)
    # invert the tropospheric pressure law p/p0 = (T/T0)^(-g/(beta R))
    texp = -beta * R / g0
    return T0 / beta * (pratio ** texp - 1.0)


def host_scalar(fn, *args):
    """Evaluate an aero function on Python floats in float64 on the CPU
    and return a Python float (constants such as the 35,000 ft reference
    pressure are formed at double precision, then meet the state's
    tensors in their dtype)."""
    t = [torch.tensor(float(a), dtype=torch.float64) for a in args]
    return float(fn(*t))
