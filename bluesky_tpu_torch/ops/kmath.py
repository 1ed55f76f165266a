"""Polynomial inverse trig of ``bluesky_tpu/ops/kmath.py``, as formulas.

The conflict-detection tile geometry (``cd_tiled.tile_geometry``) and the
CUDA tile body use these evaluations, not ``torch.atan2``/``torch.asin``,
so the plain PyTorch versions and the kernels compute the same numbers
as the JAX reference: Cephes-style odd minimax polynomials, ~1 ulp f32.
"""
import torch

_PI = 3.14159265358979323846
_PI_2 = 1.57079632679489661923
_PI_4 = 0.78539816339744830962
_TAN_PI_8 = 0.41421356237309503


def _atan_pos(z):
    """arctan for z >= 0 (Cephes atanf reduction + degree-7 odd poly)."""
    big = z > 1.0
    zr = torch.where(big, 1.0 / torch.clamp_min(z, 1e-30), z)
    red = zr > _TAN_PI_8
    z2 = torch.where(red, (zr - 1.0) / (zr + 1.0), zr)
    zz = z2 * z2
    p = ((8.05374449538e-2 * zz - 1.38776856032e-1) * zz
         + 1.99777106478e-1) * zz - 3.33329491539e-1
    y = z2 + z2 * zz * p
    y = torch.where(red, y + _PI_4, y)
    return torch.where(big, _PI_2 - y, y)


def atan(x):
    return torch.sign(x) * _atan_pos(torch.abs(x))


def atan2(y, x):
    """Four-quadrant arctangent; atan2(0, x>0)=0, atan2(0, x<0)=pi,
    atan2(0, 0)=0."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    base = _atan_pos(ay / torch.clamp_min(ax, 1e-30))
    ang = torch.where(x >= 0.0, base, _PI - base)
    return torch.where(y >= 0.0, ang, -ang)


def asin(x):
    """arcsin on [-1, 1] via atan2(x, sqrt(1-x^2))."""
    x = torch.clamp(x, -1.0, 1.0)
    return atan2(x, torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0)))


def asin_taylor(s):
    """Odd Taylor arcsin for the haversine arc length, |s| <= 1 (exact to
    f32 for every distance that can flip a conflict or LoS flag, an
    under-estimate only for pairs beyond ~400 km)."""
    s2 = s * s
    return s * (1.0 + s2 * (1.0 / 6.0 + s2 * (3.0 / 40.0 + s2 * (
        15.0 / 336.0 + s2 * (105.0 / 3456.0)))))
