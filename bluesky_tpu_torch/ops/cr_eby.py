"""Eby conflict resolution on tensors.

Port of ``bluesky_tpu/ops/cr_eby.py`` (reference Eby.py:15-138, the
Eby method for straight-line motion): for each conflict pair the time
``tstar`` of the largest intrusion comes from a quadratic, and the
velocity is displaced by ``intrusion * drelstar / (dstarabs * tstar)``.
With the directional conflict matrix the pair (j, i) displaces by minus
the pair (i, j), so ``dv[i] = -sum_j swconfl[i, j] * dv_pair(i, j)``
gives both of the reference's per-pair updates.  ``pair_contrib`` is
the per-pair body the tile kernels and the tiled row loop share.
"""
import torch

from . import aero, geo


def pair_contrib(dx, dy, dz, vx, vy, vz, rpz_m):
    """Per-pair Eby displacement (Eby.py:73-138), any broadcast shape.

    ``dx/dy/dz`` the intruder's position relative to the ownship,
    ``vx/vy/vz`` the relative TAS-based velocity (v_j - v_i).  Returns
    (dve_p, dvn_p, dvv_p) in the inputs' dtype; callers sum them over
    the conflict pairs, and ``resolve_from_sums`` negates.

    The pair is evaluated in units of the zone radius, as in the JAX
    function (in metres the quadratic's ``b*b`` overflows float32 for
    pairs a few hundred km apart), and always in float64.  On a
    near-grazing conflict ``b*b`` and ``4ac`` agree to 1e-6 and the
    intrusion ``1 - dstarabs`` cancels too, so float32 arithmetic moves
    the displacement by up to tens of percent; compiled JAX owes the
    accuracy it has there to fused multiply-adds that no op-for-op port
    reproduces.  In float64 the pair is as exact as its float32 inputs
    allow; the CUDA tile kernels compute it in double precision too."""
    dtype = dx.dtype
    dx, dy, dz, vx, vy, vz = (
        t.to(torch.float64) for t in (dx, dy, dz, vx, vy, vz))
    eps = 1e-12
    s = 1.0 / rpz_m
    dx, dy, dz = dx * s, dy * s, dz * s
    vx, vy, vz = vx * s, vy * s, vz * s
    d2 = dx * dx + dy * dy + dz * dz
    v2 = vx * vx + vy * vy + vz * vz
    dv = dx * vx + dy * vy + dz * vz

    # the quadratic for tstar (Eby.py:104-117), zone radius 1
    a = v2 - dv * dv
    b = 2.0 * dv * (1.0 - d2)
    c = d2 - d2 * d2
    discrim = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
    a_safe = torch.where(torch.abs(a) < eps, torch.full_like(a, eps), a)
    sq = torch.sqrt(discrim)
    time1 = (-b + sq) / (2.0 * a_safe)
    time2 = (-b - sq) / (2.0 * a_safe)
    tstar = torch.minimum(torch.abs(time1), torch.abs(time2))

    # relative position at tstar (Eby.py:120-122)
    dsx = dx + vx * tstar
    dsy = dy + vy * tstar
    dsz = dz + vz * tstar
    dstarabs = torch.sqrt(dsx * dsx + dsy * dsy + dsz * dsz)

    # exact collision course (Eby.py:125-131): passing within 10 m,
    # push drelstar sideways to 10 m
    dif = 10.0 * s - dstarabs
    vperp_norm = torch.sqrt(vy * vy + vx * vx)
    vp_safe = torch.where(vperp_norm < eps, torch.full_like(vperp_norm, eps),
                          vperp_norm)
    fixmask = (dif > 0.0).to(dif.dtype)
    dsx = dsx + fixmask * dif * (-vy) / vp_safe
    dsy = dsy + fixmask * dif * vx / vp_safe
    dstarabs = torch.sqrt(dsx * dsx + dsy * dsy + dsz * dsz)

    # intrusion and displacement (Eby.py:134-138); 1/s restores metres
    intr = 1.0 - dstarabs
    denom = dstarabs * tstar
    denom = torch.where(torch.abs(denom) < eps, torch.full_like(denom, eps),
                        denom)
    scale = intr / (denom * s)
    return tuple((scale * d).to(dtype) for d in (dsx, dsy, dsz))


def resolve_from_sums(sum_dve, sum_dvn, sum_dvv, alt, vs, trk, tas, vmin,
                      vmax):
    """Eby commands from the per-ownship sums of the conflict pairs'
    ``pair_contrib`` (Eby.py:42-61).  Returns (newtrk, newtas, newvs,
    newalt); ``newtas`` is the capped EAS, a reference quirk kept."""
    trkrad = geo.radians(trk)
    ve = tas * torch.sin(trkrad)
    vn = tas * torch.cos(trkrad)
    newv_e = -sum_dve + ve
    newv_n = -sum_dvn + vn
    newv_v = -sum_dvv + vs
    newtrk = geo.degrees(torch.atan2(newv_e, newv_n)) % 360.0
    newgs = torch.sqrt(newv_e * newv_e + newv_n * newv_n)
    newtas = torch.clamp(aero.vtas2eas(newgs, alt), vmin, vmax)
    newalt = torch.sign(newv_v) * 1e5
    return newtrk, newtas, newv_v, newalt


#: Ownship rows of the dense ``resolve`` evaluated at once: its float64
#: pair temporaries stay [ROWS, N] (a whole [N, N] pass peaked at 30 GiB
#: at 10,240 slots on an H100, ``PERF.md`` §6).
ROWS = 1024


def resolve(cd, alt, vs, trk, tas, rpz_m, vmin, vmax):
    """Eby commands on the dense [N, N] matrices of ``cd``
    (``cd.ConflictData``): velocities from TAS, as the reference builds
    them, so the EAS cap does not depend on the wind.  The pairs are
    evaluated ``ROWS`` ownship rows at a time.  Returns (newtrk, newtas,
    newvs, newalt)."""
    trkrad = geo.radians(trk)
    ve = tas * torch.sin(trkrad)
    vn = tas * torch.cos(trkrad)
    n = alt.shape[-1]
    zero = torch.zeros((), dtype=alt.dtype, device=alt.device)
    sums = []
    for s0 in range(0, n, ROWS):
        r = slice(s0, min(s0 + ROWS, n))
        qdrrad = geo.radians(cd.qdr[..., r, :])
        dist = cd.dist[..., r, :]
        dve_p, dvn_p, dvv_p = pair_contrib(
            dist * torch.sin(qdrrad), dist * torch.cos(qdrrad),
            alt[..., None, :] - alt[..., r, None],
            ve[..., None, :] - ve[..., r, None],
            vn[..., None, :] - vn[..., r, None],
            vs[..., None, :] - vs[..., r, None], rpz_m)
        # a masked pair adds 0, even where its displacement is not finite
        m = cd.swconfl[..., r, :]
        sums.append(torch.stack([torch.where(m, d, zero).sum(-1)
                                 for d in (dve_p, dvn_p, dvv_p)]))
    sum_dve, sum_dvn, sum_dvv = torch.cat(sums, -1)
    return resolve_from_sums(sum_dve, sum_dvn, sum_dvv, alt, vs, trk, tas,
                             vmin, vmax)
