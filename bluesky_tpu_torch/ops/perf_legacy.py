"""Legacy/BADA performance kernels: flight phases, energy-share factor,
envelope limits.

Port of ``bluesky_tpu/ops/perf_legacy.py``: elementwise parity with the
reference ``traffic/performance/legacy/performance.py`` (phases :45-144,
esf :155-211, calclimits :214-268), shared by the BS legacy model and
BADA.  Plain elementwise PyTorch on the inputs' device and dtype: the
JAX package runs these on no step path either (only its tests call
them), so there is no kernel to write.  A boolean mask enters
arithmetic only after a cast to the float operand's dtype, so float32
inputs stay float32 and float64 stay float64.
"""
import torch

from . import aero

# Phase codes (performance.py:25-33)
PHASE_NONE, PHASE_TO, PHASE_IC, PHASE_CR, PHASE_AP, PHASE_LD, PHASE_GD = \
    range(7)


def _f(mask, like):
    """``mask`` as 0/1 in the dtype of the float tensor ``like``."""
    return mask.to(like.dtype)


def phases(alt, gs, delalt, cas, vmto, vmic, vmap, vmcr, vmld, bank,
           bphase, swhdgsel, bada=False):
    """Flight-phase classification + nominal bank angle per phase.

    Parity: performance.py:45-144.  ``bphase`` is the [6] per-phase bank
    table; returns (phase int32 [N], bank [N]).
    """
    ft, kts = aero.ft, aero.kts
    to = (alt < 400.0 * ft) & (gs > 30.0 * kts) & (delalt >= 0.0)
    ic = (alt >= 400.0 * ft) & (alt < 2000.0 * ft) & (delalt > 0.0)

    cra = (alt >= 2000.0 * ft) & (delalt >= 0.0)
    crb = alt > 8000.0 * ft
    crc = (alt <= 8000.0 * ft) & (delalt <= 0.0) \
        & (cas >= vmcr + 10.0 * kts)
    cr = cra | crb | crc

    apa = (alt > ft) & (alt <= 8000.0 * ft) & (cas < vmcr + 10.0 * kts) \
        & (delalt <= 0.0)
    if bada:
        abspd = (cas >= vmap + 10.0 * kts) & (cas < vmcr + 10.0 * kts)
    else:
        abspd = cas >= vmap + 10.0 * kts
    apb = (alt > ft) & (alt <= 3000.0 * ft) & abspd & (delalt <= 0.0)
    ap = apa | apb

    if bada:
        lspd = cas < vmap + 10.0 * kts
    else:
        lspd = gs >= 30.0 * kts
    ld = (alt <= 3000.0 * ft) & lspd & (delalt <= 0.0)

    gd = alt <= ft

    # maximum.reduce over the numbered phases (performance.py:122-124)
    phase = torch.stack([
        to * PHASE_TO, ic * PHASE_IC, ap * PHASE_AP,
        ld * PHASE_LD, cr * PHASE_CR, gd * PHASE_GD]).amax(dim=0)
    phase = phase.to(torch.int32)

    bank = torch.as_tensor(bank, dtype=alt.dtype, device=alt.device)
    bank = torch.broadcast_to(bank, alt.shape)
    bank_tbl = torch.as_tensor(bphase, dtype=alt.dtype, device=alt.device)
    bank = torch.where(phase > 0,
                       bank_tbl[torch.clamp_min(phase - 1, 0).long()], bank)
    # non-turning aircraft: no bank (performance.py:140-142)
    noturn = _f(swhdgsel, alt) * 100.0
    bank = torch.minimum(noturn, bank)
    return phase, bank


def esf(abco, belco, alt, mach, climb, descent, delspd):
    """Energy-share factor (BADA 3.12 manual p.15; performance.py:155-211).

    abco/belco: above/below crossover altitude flags; climb/descent:
    vertical intent flags; delspd: commanded speed change.
    """
    gamma, gamma1, gamma2 = aero.gamma, aero.gamma1, aero.gamma2
    R, beta, g0 = aero.R, aero.beta, aero.g0
    m2 = mach * mach

    cspd = delspd == 0.0
    acc = delspd > 0.0
    dec = delspd < 0.0
    abtp = alt > 11000.0
    beltp = alt < 11000.0

    efa = 1.0 * _f(cspd & abco & abtp, mach)
    efb = (1.0 / (1.0 + ((gamma * R * beta) / (2.0 * g0)) * m2)) \
        * _f(cspd & abco & beltp, mach)
    efc = (1.0 / (1.0 + (((gamma * R * beta) / (2.0 * g0)) * m2)
                  + ((1.0 + gamma1 * m2) ** (-1.0 / (gamma - 1.0)))
                  * (((1.0 + gamma1 * m2) ** gamma2) - 1.0))) \
        * _f(cspd & belco & beltp, mach)
    efd = (1.0 / (1.0 + ((1.0 + gamma1 * m2) ** (-1.0 / (gamma - 1.0)))
                  * (((1.0 + gamma1 * m2) ** gamma2) - 1.0))) \
        * _f(cspd & belco & abtp, mach)
    efe = 0.3 * _f(acc & climb, mach)
    eff = 0.3 * _f(dec & descent, mach)
    efg = 1.7 * _f(dec & climb, mach)
    efh = 1.7 * _f(acc & descent, mach)

    out = torch.stack([efa, efb, efc, efd, efe, eff, efg, efh]).amax(dim=0)
    return torch.maximum(out, _f(out == 0.0, out))


def calclimits(desspd, gs, to_spd, vmin, vmo, mmo, mach, alt, hmaxact,
               desalt, desvs, maxthr, thr, drag, tas, mass, esf_, phase):
    """Envelope limit flags/values (performance.py:214-268).

    Returns (limspd, limspd_flag, limalt, limalt_flag, limvs, limvs_flag)
    with the reference's -999/-9999 sentinels.
    """
    g0 = aero.g0
    limspd = torch.where(desspd < vmin, vmin, -999.0)
    limspd_flag = desspd < vmin
    limspd = torch.where(desspd > vmo, vmo, limspd)
    limspd_flag = limspd_flag | (desspd > vmo)
    limspd = torch.where(mach > mmo, aero.vmach2cas(mmo - 0.01, alt),
                         limspd)
    limspd_flag = limspd_flag | (mach > mmo)
    limspd_flag = limspd_flag & ~(torch.abs(desspd - limspd) < 0.1)
    limspd = torch.where(~limspd_flag, -999.0, limspd)

    limalt = torch.where(desalt > hmaxact, hmaxact - 1.0, -999.0)
    limalt_flag = desalt > hmaxact
    near = torch.abs(desalt - hmaxact) < 0.1
    limalt = torch.where(near, -999.0, limalt)
    limalt_flag = limalt_flag & ~near

    thr_corr = torch.where(thr > maxthr - 1.0, maxthr - 1.0, thr)
    limvs = torch.where(thr > maxthr - 1.0,
                        ((thr_corr - drag) * tas) / (mass * g0) * esf_,
                        -9999.0)
    limvs_flag = limvs > -9999.0

    belowrot = (desvs > 0.0) & (gs < to_spd) & (phase == PHASE_GD)
    limvs = torch.where(belowrot, 0.0, limvs)
    limvs_flag = limvs_flag | belowrot

    atrot = (torch.abs(to_spd - gs) < 0.1) \
        & ((phase == PHASE_GD) | (phase == PHASE_TO))
    limvs = torch.where(atrot, -9999.0, limvs)
    limvs_flag = limvs_flag | atrot

    # remove non-needed limits (performance.py:262-266); NB the reference
    # overwrites Thr before testing limvs, kept operation-for-operation
    thr2 = torch.where(maxthr - thr < 2.0, -9999.0, thr)
    limvs = torch.where(maxthr - thr2 < 2.0, -9999.0, limvs)
    limvs_flag = limvs_flag & ~(limvs < -999.0)

    return limspd, limspd_flag, limalt, limalt_flag, limvs, limvs_flag
