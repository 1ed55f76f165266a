"""Vectorized OpenAP-style aircraft performance model.

Port of ``bluesky_tpu/core/perf.py``: flight-phase inference, phase
envelopes, drag polar, bypass-ratio thrust model and fuel flow.
"""
import torch

from ..models.perf_coeffs import (
    PH_TO, PH_IC, PH_CL, PH_CR, PH_DE, PH_AP, PH_LD, PH_GD)
from ..ops import aero, geo, ties

# Constants of the in-flight thrust model, formed at double precision
# on the host (the JAX package forms them from weakly-typed scalars).
_P10 = aero.host_scalar(aero.vpressure, 10000 * aero.ft)
_P35 = aero.host_scalar(aero.vpressure, 35000 * aero.ft)
_MACH_REF = 0.8
_VCAS_REF = aero.host_scalar(aero.vmach2cas, _MACH_REF, 35000 * aero.ft)


#: The JAX step divides by these unit constants; XLA compiles ``x / c``
#: as ``x * (1 / c)``, which can round one ulp below the quotient.  The
#: autopilot holds aircraft exactly on the thresholds (1500 fpm, FL050:
#: ``7.62 / 0.00508 == 1500`` but ``7.62 * (1 / 0.00508) < 1500``), so
#: the port multiplies by the same reciprocals to take JAX's branches.
_PER_FPM = 1.0 / aero.fpm
_PER_FT = 1.0 / aero.ft


def infer_phase(tas, vs, alt):
    """Fixed-wing flight phase from state (later rules override)."""
    roc_fpm = vs * _PER_FPM
    alt_ft = alt * _PER_FT
    ph = torch.zeros(tas.shape, dtype=torch.int32, device=tas.device)
    w = lambda c, v, p: torch.where(c, torch.full_like(p, v), p)
    ph = w((alt_ft <= 10) & (roc_fpm <= 100) & (roc_fpm >= -100), PH_GD, ph)
    ph = w((alt_ft >= 0) & (alt_ft <= 1000) & (roc_fpm >= 0), PH_IC, ph)
    ph = w((alt_ft >= 0) & (alt_ft <= 1000) & (roc_fpm <= 0), PH_AP, ph)
    ph = w((alt_ft >= 1000) & (roc_fpm >= 100), PH_CL, ph)
    ph = w((alt_ft >= 1000) & (roc_fpm <= -100), PH_DE, ph)
    ph = w((alt_ft >= 5000) & (roc_fpm <= 100) & (roc_fpm >= -100), PH_CR, ph)
    return ph


def _thrust_ratio_takeoff(bpr, tas, alt):
    g0c = 0.0606 * bpr + 0.6337
    mach = aero.vtas2mach(tas, alt)
    pp = aero.vpressure(alt) / aero.p0
    a = -0.4327 * pp ** 2 + 1.3855 * pp + 0.0472
    z = 0.9106 * pp ** 3 - 1.7736 * pp ** 2 + 1.8697 * pp
    x = 0.1377 * pp ** 3 - 0.4374 * pp ** 2 + 1.3003 * pp
    return (a - 0.377 * (1 + bpr) / torch.sqrt((1 + 0.82 * bpr) * g0c) * z * mach
            + (0.23 + 0.19 * torch.sqrt(bpr)) * x * mach ** 2)


def _thrust_ratio_inflight(tas, alt, vs, thr0):
    roc = torch.abs(vs * _PER_FPM)
    v = ties.maximum(tas, 10.0)
    mach = aero.vtas2mach(v, alt)
    vcas = aero.vtas2cas(v, alt)
    p = aero.vpressure(alt)
    f35 = (200 + 0.2 * thr0 / 4.448) * 4.448
    full = lambda x: torch.full_like(tas, x)

    mratio = mach / _MACH_REF
    d = torch.where(
        mratio < 0.85, full(0.73), torch.where(
            mratio < 0.92, 0.73 + (0.69 - 0.73) / (0.92 - 0.85) * (mratio - 0.85),
            torch.where(
                mratio < 1.08, 0.66 + (0.63 - 0.66) / (1.08 - 1.00) * (mratio - 1.00),
                torch.where(
                    mratio < 1.15, 0.63 + (0.60 - 0.63) / (1.15 - 1.08) * (mratio - 1.08),
                    full(0.60)))))
    b = mratio ** (-0.11)
    ratio_seg3 = d * torch.log(p / _P35) + b

    vratio = vcas / _VCAS_REF
    a = vratio ** (-0.1)
    n = torch.where(roc < 1500, full(0.89),
                    torch.where(roc < 2500, full(0.93), full(0.97)))
    ratio_seg2 = a * (p / _P35) ** (-0.355 * vratio + n)

    f10 = f35 * a * (_P10 / _P35) ** (-0.355 * vratio + n)
    m = torch.where(vratio < 0.67, full(0.4),
                    torch.where(vratio < 0.75, full(0.39),
                                torch.where(vratio < 0.83, full(0.38),
                                            torch.where(vratio < 0.92,
                                                        full(0.37),
                                                        full(0.36)))))
    m = torch.where(roc < 1500, m - 0.06, torch.where(roc < 2500, m - 0.01, m))
    ratio_seg1 = m * (p / _P35) + (f10 / f35 - m * (_P10 / _P35))

    ratio = torch.where(alt > 35000 * aero.ft, ratio_seg3,
                        torch.where(alt > 10000 * aero.ft, ratio_seg2,
                                    ratio_seg1))
    return ratio * f35 / thr0


def update(perf, tas, vs, alt):
    """Per-step performance update; returns (new PerfArrays, bank [rad])."""
    phase = infer_phase(tas, vs, alt)
    er = (phase == PH_CL) | (phase == PH_CR) | (phase == PH_DE)
    vmin = torch.zeros_like(tas)
    vmin = torch.where(phase == PH_TO, perf.vminto, vmin)
    vmin = torch.where(phase == PH_IC, perf.vminic, vmin)
    vmin = torch.where(er, perf.vminer, vmin)
    vmin = torch.where(phase == PH_AP, perf.vminap, vmin)
    vmin = torch.where(phase == PH_LD, perf.vminld, vmin)

    vmax = torch.where(phase == PH_TO, perf.vmaxto, perf.vmaxer)
    vmax = torch.where(phase == PH_IC, perf.vmaxic, vmax)
    vmax = torch.where(phase == PH_AP, perf.vmaxap, vmax)
    vmax = torch.where(phase == PH_LD, perf.vmaxld, vmax)

    cd0 = perf.cd0_clean
    cd0 = torch.where(phase == PH_TO, perf.cd0_to, cd0)
    cd0 = torch.where(phase == PH_IC, perf.cd0_ic, cd0)
    cd0 = torch.where(phase == PH_AP, perf.cd0_ap, cd0)
    cd0 = torch.where(phase == PH_LD, perf.cd0_ld, cd0)
    cd0 = torch.where(phase == PH_GD, perf.cd0_gd, cd0)

    rho = aero.vdensity(alt)
    safe_tas = ties.maximum(tas, 1.0)
    rhovs = 0.5 * rho * safe_tas * safe_tas * perf.sref
    cl = perf.mass * aero.g0 / rhovs
    drag = rhovs * (cd0 + perf.k * cl * cl)

    thr0 = perf.engnum * perf.engthrust
    tr_to = _thrust_ratio_takeoff(perf.engbpr, tas, alt)
    tr_if = _thrust_ratio_inflight(tas, alt, vs, thr0)
    tr = torch.zeros_like(tas)
    tr = torch.where(phase == PH_TO, tr_to, tr)
    tr = torch.where((phase == PH_IC) | (phase == PH_CL) | (phase == PH_CR),
                     tr_if, tr)
    tr = torch.where(phase == PH_DE, 0.15 * tr_if, tr)
    thrust = thr0 * tr
    fuelflow = perf.engnum * (perf.ff_a * tr * tr + perf.ff_b * tr + perf.ff_c)

    bank_deg = torch.full_like(tas, 25.0)
    bank_deg = torch.where((phase == PH_TO) | (phase == PH_LD),
                           torch.full_like(tas, 15.0), bank_deg)
    bank_deg = torch.where((phase == PH_IC) | (phase == PH_CR) | (phase == PH_AP),
                           torch.full_like(tas, 35.0), bank_deg)
    bank = geo.radians(bank_deg)
    new_perf = perf.replace(phase=phase, vmin=vmin, vmax=vmax,
                            thrust=thrust, drag=drag, fuelflow=fuelflow)
    return new_perf, bank


def limits(perf, intent_tas, intent_vs, intent_alt, ax, smooth=None):
    """Clip pilot intents to the flight envelope.  With ``smooth`` (a
    ``diff.smooth.SmoothConfig`` with ``ste_caps``) the CAS clamp is
    straight-through: the same forward value, the gradient of the
    identity, so gradients flow through an intent pinned at a limit."""
    allow_alt = torch.minimum(intent_alt, perf.hmax)
    intent_cas = aero.vtas2cas(intent_tas, allow_alt)
    if smooth is not None and smooth.ste_caps:
        from ..diff.smooth import ste_clip
        allow_cas = ste_clip(intent_cas, perf.vmin, perf.vmax)
    else:
        allow_cas = ties.clip(intent_cas, perf.vmin, perf.vmax)
    allow_tas = aero.vcas2tas(allow_cas, allow_alt)
    vs_max_with_acc = (1.0 - ax / perf.axmax) * perf.vsmax
    allow_vs = torch.where(intent_vs > perf.vsmax, vs_max_with_acc, intent_vs)
    allow_vs = torch.where(intent_vs < perf.vsmin, perf.vsmin, allow_vs)
    return allow_tas, allow_vs, allow_alt


def acceleration(phase, like):
    """Fixed phase-dependent acceleration magnitude, in ``like``'s dtype."""
    return torch.where(phase == PH_GD, torch.full_like(like, 2.0),
                       torch.full_like(like, 0.5))
