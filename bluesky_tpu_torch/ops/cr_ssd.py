"""SSD conflict resolution: the solution-space diagram on a velocity grid.

Port of ``bluesky_tpu/ops/cr_ssd.py``.  The reference (SSD.py:99-625)
clips velocity-obstacle polygons with pyclipper; the JAX package, and
this port, discretise the solution space instead: the candidate
velocities are a polar grid of ``ntrk`` tracks by ``nspd`` speeds over
[vmin, vmax] plus two per-aircraft specials, the current velocity and
the autopilot velocity.  A candidate lies in the obstacle of intruder j
when flying it would come within ``rpz_m`` of j inside the lookahead
(the CPA predicate of the conflict detection).  The intruder axis (the
dense ``resolve``) or the candidate axis (``resolve_from_partners``) is
walked in chunks, so the largest temporary is [N, C, chunk] (at most
512 MB) or [N, chunk, P].

The priority codes RS1-RS9 (SSD.py:369-399, 429-558) are masks and
objectives over the one free set: RS1 the free candidate nearest the
current velocity, RS2 / RS9 the right / left half-plane of the heading,
RS3 the autopilot speed ring, RS4 the own-heading wedge, RS5 nearest
the autopilot velocity (which wins when free), RS6 the rules of the air
with RS2's right turn, RS7 / RS8 a second layer from the intruders
within half the ADS-B range.  A restricted set falls back to the whole
free set, and with nothing free to the latest earliest conflict.
"""
from typing import NamedTuple

import torch

from . import geo

ADSB_MAX = 65.0 * 1852.0     # [m] SSD.py:110 adsbmax


class SSDConfig(NamedTuple):
    ntrk: int = 24        # track samples (15 deg)
    nspd: int = 6         # speed ring samples between vmin and vmax
    rpz_m: float = 9260.0  # resolution zone [m]
    tlookahead: float = 300.0
    priocode: str = "RS1"
    chunk: int = 512      # intruder-axis slab of the dense resolve


def _wrap180(a):
    return torch.remainder(a + 180.0, 360.0) - 180.0


def _vo_conf(wve, wvn, dx, dy, ok, cfg):
    """The candidate-vs-intruder CPA predicate on broadcast operands
    (``w = v_j - u_c``, StateBasedCD.py:39-40): (conflict, entry time)."""
    r2 = cfg.rpz_m * cfg.rpz_m
    dv2 = wve * wve + wvn * wvn
    dv2 = torch.where(dv2 < 1e-6, torch.full_like(dv2, 1e-6), dv2)
    tcpa = -(wve * dx + wvn * dy) / dv2
    dcpa2 = dx * dx + dy * dy - tcpa * tcpa * dv2
    dtinhor = torch.sqrt(torch.clamp_min(r2 - dcpa2, 0.0) / dv2)
    tin = tcpa - dtinhor
    conf = ((dcpa2 < r2) & (tcpa + dtinhor > 0.0) & (tin < cfg.tlookahead)
            & ok)
    return conf, tin


def _reduce(conf, tin, dim):
    """(any conflict, earliest non-negative entry time; 1e18 for none)."""
    big = torch.full((), 1e18, dtype=tin.dtype, device=tin.device)
    return (conf.any(dim),
            torch.where(conf, torch.clamp_min(tin, 0.0), big).amin(dim))


#: The most elements of one [N, C, chunk] temporary of the dense obstacle
#: test (2^27 float32, 512 MB): eager PyTorch keeps every temporary of a
#: slab alive at once, where compiled JAX fuses them.
_SLAB_ELEMENTS = 1 << 27


def _vo_masks(cve, cvn, dxm, dym, gseast, gsnorth, pairok, cfg):
    """Candidate obstacle test against every intruder of the [N, N]
    geometry, the intruder axis in slabs of ``cfg.chunk`` intruders, or
    fewer where an [N, C, chunk] slab would pass ``_SLAB_ELEMENTS`` (the
    reductions are exact, so the slab width changes no result).
    ``cve/cvn`` [..., N, C], the geometry [..., N, N] (a leading world
    axis broadcasts).  Returns (anyconf [..., N, C], min_tin)."""
    n = cve.shape[-2]
    step = max(1, min(cfg.chunk, _SLAB_ELEMENTS // cve.numel()))
    anyc = mint = None
    for s in range(0, n, step):
        e = min(s + step, n)
        dx = dxm[..., :, None, s:e]
        dy = dym[..., :, None, s:e]
        wve = gseast[..., None, None, s:e] - cve[..., :, :, None]
        wvn = gsnorth[..., None, None, s:e] - cvn[..., :, :, None]
        a, m = _reduce(*_vo_conf(wve, wvn, dx, dy, pairok[..., :, None, s:e],
                                 cfg), -1)
        anyc = a if anyc is None else anyc | a
        mint = m if mint is None else torch.minimum(mint, m)
    return anyc, mint


def _pick(free, allowed, dist2, min_tin):
    """The free candidate nearest by ``dist2``, in the ``allowed`` set
    when it holds a free one (SSD.py:317-333), else the latest earliest
    conflict when nothing is free.  Returns (index [N], any free [N])."""
    big = torch.full((), 1e18, dtype=dist2.dtype, device=dist2.device)
    free_r = free & allowed
    has_r = free_r.any(1)
    has_f = free.any(1)
    sel = torch.where(has_r[:, None], free_r, free)
    best_free = torch.argmin(torch.where(sel, dist2, big), dim=1)
    best_delay = torch.argmax(torch.where(torch.isfinite(min_tin), min_tin,
                                          torch.zeros_like(min_tin)), dim=1)
    return torch.where(has_f, best_free, best_delay), has_f


def _linspace(lo, hi, num, endpoint, dtype, device):
    """``jnp.linspace`` (num > 1), in its arithmetic: ``lo * (1 - t) +
    hi * t`` with ``t = k / div`` in ``dtype``, the end sample exact."""
    div = (num - 1) if endpoint else num
    # fills, not copies from the host: a copy would wait for the card
    lo, hi = (torch.full((), v, dtype=dtype, device=device) for v in (lo, hi))
    t = torch.arange(div, dtype=dtype, device=device) / div
    out = lo * (1 - t) + hi * t
    return torch.cat([out, hi[None]]) if endpoint else out


def _candidate_grid(n, rule, cfg, dtype, hdg, ap_tas, ap_ve, ap_vn,
                    gseast, gsnorth, vmin, vmax):
    """[N, C] candidate velocities: the polar grid, then the current
    velocity ([C-2]) and the autopilot velocity ([C-1]).  Returns (cve,
    cvn, ctrk)."""
    dev = gseast.device
    if rule == "RS3":      # heading only: every track at the AP speed
        ctrk = _linspace(0.0, 360.0, cfg.ntrk, False, dtype, dev)[None, :] \
            .repeat(n, 1)
        cspd = torch.clamp(ap_tas, vmin, vmax)[:, None].repeat(1, cfg.ntrk)
    elif rule == "RS4":    # speed only: the own-heading wedge
        cspd = _linspace(vmin, vmax, cfg.nspd, True, dtype, dev)[None, :] \
            .repeat(n, 1)
        ctrk = hdg[:, None].repeat(1, cfg.nspd)
    else:
        trks = _linspace(0.0, 360.0, cfg.ntrk, False, dtype, dev)
        spds = _linspace(vmin, vmax, cfg.nspd, True, dtype, dev)
        ctrk = trks.repeat_interleave(cfg.nspd)[None, :].repeat(n, 1)
        cspd = spds.repeat(cfg.ntrk)[None, :].repeat(n, 1)
    cve = cspd * torch.sin(geo.radians(ctrk))
    cvn = cspd * torch.cos(geo.radians(ctrk))
    cve = torch.cat([cve, gseast[:, None], ap_ve[:, None]], 1)
    cvn = torch.cat([cvn, gsnorth[:, None], ap_vn[:, None]], 1)
    return cve, cvn, ctrk


def _select_best(rule, cve, cvn, ctrk, hdg, free, min_tin, masks_near,
                 ap_ve, ap_vn, gseast, gsnorth):
    """The rule-restricted pick, the RS7/RS8 near layer and the RS5
    autopilot override, shared by both obstacle sources.  ``masks_near``
    is a thunk giving (anyconf, min_tin) of the half-ADS-B-range layer.
    Returns (track, speed) of the chosen candidate."""
    n, c = cve.shape
    i_cur, i_ap = c - 2, c - 1
    rows = torch.arange(n, device=cve.device)
    if rule in ("RS5", "RS8"):
        ref_e, ref_n = ap_ve, ap_vn
    else:
        ref_e, ref_n = gseast, gsnorth
    dist2 = (cve - ref_e[:, None]) ** 2 + (cvn - ref_n[:, None]) ** 2

    allowed = torch.ones(cve.shape, dtype=torch.bool, device=cve.device)
    if rule in ("RS2", "RS6"):
        allowed[:, :-2] = _wrap180(ctrk - hdg[:, None]) >= 0.0   # right
    elif rule == "RS9":
        allowed[:, :-2] = _wrap180(ctrk - hdg[:, None]) <= 0.0   # left
    # the specials take part only where the reference consults them
    allowed[:, i_cur] = False
    allowed[:, i_ap] = rule in ("RS5", "RS8")

    best, _ = _pick(free, allowed, dist2, min_tin)
    if rule in ("RS7", "RS8"):
        # the near layer (SSD.py:113-114, 515-558): prefer its solution
        # when the current velocity conflicts there and the two differ
        anyc2, mint2 = masks_near()
        best2, has_f2 = _pick(~anyc2, allowed, dist2, mint2)
        d12 = ((cve[rows, best] - cve[rows, best2]) ** 2
               + (cvn[rows, best] - cvn[rows, best2]) ** 2)
        use2 = anyc2[:, i_cur] & has_f2 & (d12 >= 1.0)
        best = torch.where(use2, best2, best)
    if rule == "RS5":      # the AP setting wins when free (SSD.py:446-453)
        best = torch.where(free[:, i_ap], torch.full_like(best, i_ap), best)

    be, bn = cve[rows, best], cvn[rows, best]
    btrk = geo.degrees(torch.atan2(be, bn)) % 360.0
    bspd = torch.sqrt(be ** 2 + bn ** 2)
    return btrk, bspd


def _ap_velocity(trk, gs, hdg, ap_trk, ap_tas):
    hdg = trk if hdg is None else hdg
    ap_trk = trk if ap_trk is None else ap_trk
    ap_tas = gs if ap_tas is None else ap_tas
    return (hdg, ap_tas, ap_tas * torch.sin(geo.radians(ap_trk)),
            ap_tas * torch.cos(geo.radians(ap_trk)))


def _must_avoid(qdr, hdg_own, hdg_other):
    """Rules of the air (SSD.py:296-302): own gives way head-on or to
    traffic converging from the right, or when overtaking."""
    brg_own = _wrap180(qdr - hdg_own)
    brg_oth = _wrap180(qdr + 180.0 - hdg_other)
    return (((brg_own >= -20.0) & (brg_own <= 110.0))
            | (brg_oth <= -110.0) | (brg_oth >= 110.0))


def resolve(cd, lat, lon, alt, trk, gs, vs, gseast, gsnorth, active,
            vmin, vmax, cfg: SSDConfig, hdg=None, ap_trk=None, ap_tas=None):
    """Resolution velocities of the in-conflict aircraft from the dense
    [N, N] matrices of ``cd``; the others keep trk/gs.  ``hdg``,
    ``ap_trk`` and ``ap_tas`` (default trk, trk, gs) feed the heading-
    and autopilot-referenced rules.  A leading world axis ([W, N]
    columns, [W, N, N] matrices) runs the per-aircraft candidate grid
    and pick on the W * N aircraft at once.  Returns (newtrk, newgs)."""
    shape = lat.shape
    n = shape[-1]
    rule = cfg.priocode.upper()
    hdg, ap_tas, ap_ve, ap_vn = _ap_velocity(trk, gs, hdg, ap_trk, ap_tas)
    flat = lambda a: a.reshape(-1, *a.shape[len(shape):])
    cve, cvn, ctrk = _candidate_grid(flat(lat).shape[0], rule, cfg,
                                     gs.dtype, flat(hdg), flat(ap_tas),
                                     flat(ap_ve), flat(ap_vn), flat(gseast),
                                     flat(gsnorth), vmin, vmax)
    grid = lambda a: a.reshape(*shape, a.shape[-1])
    qdrrad = geo.radians(cd.qdr)
    dxm = cd.dist * torch.sin(qdrrad)
    dym = cd.dist * torch.cos(qdrrad)
    eye = torch.eye(n, dtype=torch.bool, device=lat.device)
    # only intruders within ADS-B range are seen (SSD.py:110)
    pairok = (active[..., :, None] & active[..., None, :] & ~eye
              & (cd.dist < ADSB_MAX))
    if rule == "RS6":
        pairok = pairok & _must_avoid(cd.qdr, hdg[..., :, None],
                                      hdg[..., None, :])

    def masks(ok):
        anyc, mint = _vo_masks(grid(cve), grid(cvn), dxm, dym, gseast,
                               gsnorth, ok, cfg)
        return flat(anyc), flat(mint)

    anyconf, min_tin = masks(pairok)
    near = lambda: masks(pairok & (cd.dist < ADSB_MAX / 2.0))
    btrk, bspd = _select_best(rule, cve, cvn, ctrk, flat(hdg), ~anyconf,
                              min_tin, near, flat(ap_ve), flat(ap_vn),
                              flat(gseast), flat(gsnorth))
    return (torch.where(cd.inconf, btrk.reshape(shape), trk),
            torch.where(cd.inconf, bspd.reshape(shape), gs))


def _vo_masks_pairs(cve, cvn, dx, dy, vje, vjn, ok, cfg, chunk=16):
    """The obstacle test against a gathered [N, P] partner set, the
    candidate axis in slabs of ``chunk`` (temporaries [N, chunk, P]).
    Returns (anyconf [N, C], min_tin [N, C])."""
    c = cve.shape[1]
    dxc, dyc, okc = dx[:, None, :], dy[:, None, :], ok[:, None, :]
    anyc, mint = [], []
    for s in range(0, c, chunk):
        ce = cve[:, s:s + chunk, None]
        cn = cvn[:, s:s + chunk, None]
        a, m = _reduce(*_vo_conf(vje[:, None, :] - ce, vjn[:, None, :] - cn,
                                 dxc, dyc, okc, cfg), 2)
        anyc.append(a)
        mint.append(m)
    return torch.cat(anyc, 1), torch.cat(mint, 1)


def resolve_from_partners(partners, inconf, lat, lon, alt, trk, gs, vs,
                          gseast, gsnorth, active, vmin, vmax,
                          cfg: SSDConfig, hdg=None, ap_trk=None,
                          ap_tas=None):
    """SSD from an [N, P] caller-space partner table (-1 empty): the
    obstacles of the tabled intruders only, the K most urgent conflicts
    and the still-engaged partners of the blockwise backends.  A chosen
    velocity may conflict with an untabled neighbour; the next interval
    detects that pair and resolves it (the JAX package's documented
    K-truncation).  Returns (newtrk, newgs); aircraft not in conflict
    keep trk/gs."""
    from . import cd_tiled
    n = lat.shape[0]
    rule = cfg.priocode.upper()
    hdg, ap_tas, ap_ve, ap_vn = _ap_velocity(trk, gs, hdg, ap_trk, ap_tas)
    cve, cvn, ctrk = _candidate_grid(n, rule, cfg, gs.dtype, hdg, ap_tas,
                                     ap_ve, ap_vn, gseast, gsnorth, vmin,
                                     vmax)
    valid = partners >= 0
    j = torch.clamp(partners, 0, n - 1).long()
    trig = cd_tiled.precompute_trig(lat, lon)
    own_t = {k: v[:, None] for k, v in trig.items()}
    intr_t = {k: v[j] for k, v in trig.items()}
    dist, sinqdr, cosqdr = cd_tiled.tile_geometry(own_t, intr_t)
    dx = dist * sinqdr
    dy = dist * cosqdr
    ok = valid & active[:, None] & active[j] & (dist < ADSB_MAX)
    if rule == "RS6":
        qdr = geo.degrees(torch.atan2(sinqdr, cosqdr))
        ok = ok & _must_avoid(qdr, hdg[:, None], hdg[j])
    vje, vjn = gseast[j], gsnorth[j]
    anyconf, min_tin = _vo_masks_pairs(cve, cvn, dx, dy, vje, vjn, ok, cfg)
    near = lambda: _vo_masks_pairs(cve, cvn, dx, dy, vje, vjn,
                                   ok & (dist < ADSB_MAX / 2.0), cfg)
    btrk, bspd = _select_best(rule, cve, cvn, ctrk, hdg, ~anyconf, min_tin,
                              near, ap_ve, ap_vn, gseast, gsnorth)
    return torch.where(inconf, btrk, trk), torch.where(inconf, bspd, gs)
