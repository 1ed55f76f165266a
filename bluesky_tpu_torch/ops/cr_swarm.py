"""Swarm conflict resolution on tensors: MVP avoidance, alignment and
flock centering.

Port of ``bluesky_tpu/ops/cr_swarm.py`` (reference Swarm.py:23-103):
the neighbours within 7.5 nm and 1500 ft flying within 90 deg of the
own track form the swarm; the commanded velocity blends collision
avoidance (the MVP resolution, or the autopilot command when not
ASAS-active), velocity alignment (weighted averages of speed, vertical
speed and track difference) and flock centering (towards the swarm
centroid) with weights [10, 3, 1].  ``pair_weight`` is the neighbour
predicate the tile kernels and the tiled row loop share; the blockwise
backends accumulate its seven weighted sums per ownship and call
``resolve_from_sums``.
"""
import torch

from . import aero, geo

R_SWARM = 7.5 * aero.nm      # [m] swarm neighbourhood (Swarm.py start())
DH_SWARM = 1500.0 * aero.ft  # [m]
WEIGHTS = (10.0, 3.0, 1.0)   # CA / alignment / centering


def _wavg(x, w):
    """Row-wise weighted average with an all-zero-row guard."""
    den = w.sum(-1)
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (x * w).sum(-1) / den


def wrap_track(dtrk):
    """A track difference wrapped to [-180, 180): the floored modulo of
    the JAX ``(x + 180) % 360 - 180`` (``torch.remainder``, not the
    truncating ``fmod``)."""
    return torch.remainder(dtrk + 180.0, 360.0) - 180.0


def pair_weight(dx, dy, dalt, dtrk, pairok):
    """Swarm-neighbour flag of a pair (Swarm.py:47-58, 65-66): within
    7.5 nm and 1500 ft, flying within 90 deg of the own track; ``dtrk``
    already wrapped (``wrap_track``).  Any broadcast shape."""
    close = ((dx * dx + dy * dy < R_SWARM * R_SWARM)
             & (torch.abs(dalt) < DH_SWARM) & pairok)
    return close & (torch.abs(dtrk) < 90.0)


def _blend(ca, va, fc, vmin, vmax):
    """The weighted blend of the three parts (Swarm.py:99-110); each part
    a (trk, cas, vs) triple.  Returns (newtrk, newtas, newvs, newalt)."""
    wsum = sum(WEIGHTS)

    def blend(a, b, c):
        return (WEIGHTS[0] * a + WEIGHTS[1] * b + WEIGHTS[2] * c) / wsum

    parts = (ca, va, fc)
    vxs = [c * torch.sin(geo.radians(t)) for t, c, _ in parts]
    vys = [c * torch.cos(geo.radians(t)) for t, c, _ in parts]
    newtrk = geo.degrees(torch.atan2(blend(*vxs), blend(*vys))) % 360.0
    newcas = blend(*(p[1] for p in parts))
    newvs = blend(*(p[2] for p in parts))
    newtas = torch.clamp(newcas, vmin, vmax)
    newalt = torch.sign(newvs) * 1e5
    return newtrk, newtas, newvs, newalt


def _centering(fc_dx, fc_dy, fc_dz, cas):
    """Flock-centering track and vertical speed (Swarm.py:86-97)."""
    fc_trk = geo.degrees(torch.atan2(fc_dx, fc_dy))
    cas_safe = torch.where(cas == 0.0, torch.ones_like(cas), cas)
    ttoreach = torch.sqrt(fc_dx * fc_dx + fc_dy * fc_dy) / cas_safe
    none = ttoreach == 0.0
    fc_vs = torch.where(none, torch.zeros_like(ttoreach),
                        fc_dz / torch.where(none, torch.ones_like(ttoreach),
                                            ttoreach))
    return fc_trk, fc_vs


def resolve_from_sums(sw_w, sw_cas, sw_vs, sw_dtrk, sw_dx, sw_dy, sw_alt,
                      alt, trk, cas, vs, gseast, gsnorth, active,
                      mvp_trk, mvp_tas, mvp_vs, mvp_active,
                      ap_trk, selspd, selvs, vmin, vmax):
    """Swarm commands from the per-ownship neighbour sums w, w*cas,
    w*vs, w*dtrk, w*dx, w*dy and w*alt.  The reference's diagonal terms
    (Swarm.py:53-58: w = 1, dtrk = 0, flock dx/dy the own velocity / 100)
    are added here, so the kernels never see the diagonal."""
    selfw = active.to(cas.dtype)
    den = sw_w + selfw
    den = torch.where(den == 0.0, torch.ones_like(den), den)

    va_cas = (sw_cas + selfw * cas) / den
    va_vs = (sw_vs + selfw * vs) / den
    va_trk = trk + sw_dtrk / den

    fc_dx = (sw_dx + selfw * gseast / 100.0) / den
    fc_dy = (sw_dy + selfw * gsnorth / 100.0) / den
    fc_dz = (sw_alt + selfw * alt) / den - alt
    fc_trk, fc_vs = _centering(fc_dx, fc_dy, fc_dz, cas)

    ca = (torch.where(mvp_active, mvp_trk, ap_trk),
          torch.where(mvp_active, mvp_tas, selspd),
          torch.where(mvp_active, mvp_vs, selvs))
    return _blend(ca, (va_trk, va_cas, va_vs), (fc_trk, cas, fc_vs),
                  vmin, vmax)


def resolve(cd, lat, lon, alt, trk, gs, cas, vs, gseast, gsnorth, active,
            mvp_trk, mvp_tas, mvp_vs, mvp_active, ap_trk, selspd, selvs,
            vmin, vmax):
    """Swarm commands on the dense [N, N] matrices of ``cd``: the MVP
    output ``mvp_*`` with its ASAS-active flags (Swarm runs MVP first,
    Swarm.py:68), the autopilot commands for the others, the speed caps.
    Returns (newtrk, newtas, newvs, newalt) for every aircraft."""
    n = lat.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=lat.device)
    qdrrad = geo.radians(cd.qdr)
    dx = cd.dist * torch.sin(qdrrad)
    dy = cd.dist * torch.cos(qdrrad)
    dalt = alt[..., :, None] - alt[..., None, :]
    pairok = active[..., :, None] & active[..., None, :] & ~eye
    dtrk = wrap_track(trk[..., None, :] - trk[..., :, None])
    w = (pair_weight(dx, dy, dalt, dtrk, pairok)
         | (eye & active[..., :, None])).to(gs.dtype)

    ca = (torch.where(mvp_active, mvp_trk, ap_trk),
          torch.where(mvp_active, mvp_tas, selspd),
          torch.where(mvp_active, mvp_vs, selvs))

    va_cas = _wavg(cas[..., None, :].expand_as(w), w)
    va_vs = _wavg(vs[..., None, :].expand_as(w), w)
    va_trk = trk + _wavg(dtrk, w)

    dxflock = torch.where(eye, (gseast / 100.0)[..., :, None], dx)
    dyflock = torch.where(eye, (gsnorth / 100.0)[..., :, None], dy)
    fc_dx = _wavg(dxflock, w)
    fc_dy = _wavg(dyflock, w)
    fc_dz = _wavg(alt[..., None, :].expand_as(w), w) - alt
    fc_trk, fc_vs = _centering(fc_dx, fc_dy, fc_dz, cas)
    return _blend(ca, (va_trk, va_cas, va_vs), (fc_trk, cas, fc_vs),
                  vmin, vmax)
