"""BADA 3 thrust and fuel-flow kernels.

Port of ``bluesky_tpu/ops/perf_bada.py``: elementwise parity with the
physics block of the reference ``traffic/performance/bada/perfbada.py:
390-520`` (BADA User Manual 3.12): max-climb thrust by engine type (jet /
turboprop / piston), level and phase-dependent descent thrust,
reduced-climb-power correction, and thrust-specific fuel consumption
with nominal / minimal / cruise / approach regimes.

Inputs are per-aircraft coefficient columns (from models/coeff_bada.py)
and state tensors; plain elementwise PyTorch on their device and dtype.
Like ``ops/perf_legacy.py`` these run on no step path (the JAX package's
tests are their only callers), so there is no kernel to write.
"""
import torch

from . import aero
from .perf_legacy import PHASE_CR, PHASE_AP, PHASE_LD, PHASE_GD, _f


def max_climb_thrust(alt, tas, jet, turbo, piston, ctcth1, ctcth2, ctcth3):
    """Max climb (= max available) thrust in ISA [N]
    (perfbada.py:404-429; BADA 3.12 p.32)."""
    h_ft = alt / aero.ft
    tas_kt = torch.clamp_min(tas / aero.kts, 1.0)
    tj = ctcth1 * (1.0 - h_ft / ctcth2 + ctcth3 * h_ft * h_ft)
    tt = ctcth1 / tas_kt * (1.0 - h_ft / ctcth2) + ctcth3
    tp = ctcth1 * (1.0 - h_ft / ctcth2) + ctcth3 / tas_kt
    return torch.where(jet, tj, torch.where(turbo, tt, tp * _f(piston, tp)))


def thrust(phase, climb, descent, lvl, alt, tas, drag, jet, turbo, piston,
           ctcth1, ctcth2, ctcth3, ctdesl, ctdesh, ctdesa, ctdesld,
           hpdes):
    """Thrust by flight condition (perfbada.py:404-458).

    Returns (thr, maxthr).  ``lvl`` = level flight mask.
    """
    h_ft = alt / aero.ft
    tas_kt = torch.clamp_min(tas / aero.kts, 1.0)
    tj = ctcth1 * (1.0 - h_ft / ctcth2 + ctcth3 * h_ft * h_ft)
    tt = ctcth1 / tas_kt * (1.0 - h_ft / ctcth2) + ctcth3
    tp = ctcth1 * (1.0 - h_ft / ctcth2) + ctcth3 / tas_kt
    tjc = _f(climb & jet, tj) * tj
    ttc = _f(climb & turbo, tt) * tt
    tpc = _f(climb & piston, tp) * tp
    maxthr = tj * _f(jet, tj) + tt * _f(turbo, tt) + tp * _f(piston, tp)

    tlvl = _f(lvl, drag) * drag

    delh = alt - hpdes
    high = delh > 0.0
    low = delh < 0.0
    tdesh = maxthr * ctdesh * _f(descent & high, maxthr)
    tdeslc = maxthr * ctdesl * _f(descent & low & (phase == PHASE_CR),
                                  maxthr)
    tdesla = maxthr * ctdesa * _f(descent & low & (phase == PHASE_AP),
                                  maxthr)
    tdesll = maxthr * ctdesld * _f(descent & low & (phase == PHASE_LD),
                                   maxthr)
    tgd = torch.minimum(tdesh, tdeslc) * _f(phase == PHASE_GD, maxthr)

    thr = torch.stack([tjc, ttc, tpc, tlvl, tdesh, tdeslc,
                       tdesla, tdesll, tgd]).amax(dim=0)
    return thr, maxthr


def reduced_climb_power(alt, hmaxact, climb, cred, mass, mmin, mmax):
    """Reduced-climb-power factor cpred (perfbada.py:462-469)."""
    clh = (alt < hmaxact * 0.8) & climb
    c = cred * _f(clh, mass)
    return 1.0 - c * ((mmax - mass) / (mmax - mmin))


def fuelflow(phase, alt, tas, thr, jet, turbo, piston, cf1, cf2, cf3, cf4,
             cf_cruise):
    """Fuel flow by regime (perfbada.py:483-520).

    Returns (fnom, fmin, fcr, fal): nominal, minimal, cruise, and
    approach/landing fuel flows [kg/s equivalent of the reference's
    units]; the caller selects per phase like perfbada.py:523-535.
    """
    tas_kt = tas / aero.kts
    h_ft = alt / aero.ft
    etaj = cf1 * (1.0 + tas_kt / cf2)
    etat = cf1 * (1.0 - tas_kt / cf2) * (tas_kt / 1000.0)
    eta = torch.maximum(etaj * _f(jet, etaj), etat * _f(turbo, etat)) \
        / 1000.0

    jt = _f(jet | turbo, eta)
    pis = _f(piston, eta)
    fnom = eta * thr * jt + cf1 * pis
    fmin = cf3 * (1.0 - h_ft / cf4) * jt + cf3 * pis
    fcr = eta * thr * cf_cruise * jt + cf1 * cf_cruise * pis
    fal = torch.maximum(fnom, fmin)
    return fnom, fmin, fcr, fal
