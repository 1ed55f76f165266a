"""The pairs of a fleet that need the conflict-detection work, found
without visiting all N**2 of them.

An ordered pair (i, j) of active aircraft needs the work when both
tests hold:

* horizontal: the great-circle distance is at most
  ``rpz + (gs_i + gs_j) * tlookahead``;
* vertical: ``|alt_i - alt_j| <= hpz + |vs_i - vs_j| * tlookahead``.

Every pair that state-based detection can flag, in conflict or in loss
of separation, passes both (a pair that enters the zone within the
lookahead closes at most ``(gs_i + gs_j)`` metres a second horizontally
and ``|vs_i - vs_j|`` vertically).  The ownships are taken in blocks
sorted by latitude, and each block is held only against the intruders
of its latitude band, which the horizontal test bounds.
"""
import math

import torch

from . import aero

#: the least earth radius [m] any distance below uses: bands built on
#: it hold every intruder within reach
R_BAND = 6.35e6


def sorted_band(lat, idx):
    """(latitudes of ``idx`` sorted, ``idx`` in that order)."""
    v, o = torch.sort(lat[idx])
    return v, idx[o]


def unit_vectors(lat, lon):
    """[n, 3] float32 unit vectors of positions [deg]."""
    p, l = aero.radians(lat), aero.radians(lon)
    return torch.stack([torch.cos(p) * torch.cos(l), torch.cos(p)
                        * torch.sin(l), torch.sin(p)], 1).float()


def _blocks(own_lat, band_lat, reach_deg, budget):
    """``[(b0, b1, lo, hi)]``: consecutive ownships ``b0:b1`` (sorted by
    latitude) with their band ``lo:hi`` of the sorted intruders, merged
    greedily while a block holds at most ``budget`` candidate pairs (one
    device read for all the bounds)."""
    n, step = own_lat.numel(), 32
    starts = torch.arange(0, n, step, device=own_lat.device)
    ends = torch.clamp_max(starts + step, n) - 1
    lo = torch.searchsorted(band_lat, own_lat[starts] - reach_deg)
    hi = torch.searchsorted(band_lat, own_lat[ends] + reach_deg, right=True)
    starts, lo, hi = (t.tolist() for t in (starts, lo, hi))
    out = []
    for s, l, h in zip(starts, lo, hi):
        e = min(s + step, n)
        if out and (e - out[-1][0]) * (h - out[-1][2]) <= budget:
            out[-1] = (out[-1][0], e, out[-1][2], h)
        else:
            out.append((s, e, l, h))
    return out


def needed(cols, idx_own, idx_all, rpz, hpz, tlook, radius=aero.Rearth,
           slack=0.0, pairs_per_block=2 ** 26):
    """Yield ``(own, intr)`` [P] index tensors (into the columns) of the
    ordered pairs of ownships ``idx_own`` and intruders ``idx_all`` that
    pass both tests.  ``cols``: dict of [n] tensors ``lat lon alt gs vs``
    (float64 advised).  ``radius`` is the sphere of the horizontal test;
    ``slack`` widens both tests by that share (a pair list that must
    hold every pair of a float64 computation passes ``R_BAND`` and a
    small slack).  Within an ownship block's latitude band the chord
    between unit vectors (never longer than the arc) picks the
    candidates; the tests run on those alone."""
    lat, lon, alt, gs, vs = (cols[k] for k in ("lat", "lon", "alt", "gs",
                                                "vs"))
    if idx_own.numel() == 0 or idx_all.numel() == 0:
        return
    band_lat, band_idx = sorted_band(lat, idx_all)
    band_xyz = unit_vectors(lat[band_idx], lon[band_idx])
    own_lat, own_sorted = sorted_band(lat, idx_own)
    own_xyz = unit_vectors(lat[own_sorted], lon[own_sorted])
    reach = (rpz + 2.0 * float(gs[idx_all].max()) * tlook) * (1 + slack)
    reach_deg = math.degrees(reach / R_BAND) * 1.001 + 1e-9
    # chord^2 = 2 - 2 cos(angle); float32 rounding of the dot is far
    # below the added 1e-6
    chord2 = (reach / R_BAND) ** 2 + 1e-6
    for b0, b1, lo, hi in _blocks(own_lat, band_lat, reach_deg,
                                  pairs_per_block):
        if hi <= lo:
            continue
        near = 2.0 - 2.0 * (own_xyz[b0:b1] @ band_xyz[lo:hi].T) <= chord2
        r, c = torch.nonzero(near, as_tuple=True)
        o, i = own_sorted[b0:b1][r], band_idx[lo:hi][c]
        dist = great_circle(lat[o], lon[o], lat[i], lon[i], radius)
        hor = dist <= (rpz + (gs[o] + gs[i]) * tlook) * (1 + slack)
        dvs = torch.clamp_min(torch.abs(vs[i] - vs[o]), 1e-6)
        ver = torch.abs(alt[i] - alt[o]) <= (hpz + dvs * tlook) * (1 + slack)
        ok = hor & ver & (o != i)
        yield o[ok], i[ok]


def batched(pairs, size=2 ** 22):
    """The pair lists of ``pairs`` joined into lists of at least ``size``
    pairs (fewer, larger launches downstream)."""
    buf, n = [], 0
    for o, i in pairs:
        buf.append((o, i))
        n += o.numel()
        if n >= size:
            yield torch.cat([b[0] for b in buf]), torch.cat([b[1] for b in buf])
            buf, n = [], 0
    if buf:
        yield torch.cat([b[0] for b in buf]), torch.cat([b[1] for b in buf])


def great_circle(lat1, lon1, lat2, lon2, radius):
    """Haversine distance [m] on a sphere of ``radius`` (a number or a
    tensor broadcasting with the positions)."""
    p1, p2 = aero.radians(lat1), aero.radians(lat2)
    dl = aero.radians(lon2 - lon1)
    h = (torch.sin(0.5 * (p2 - p1)) ** 2
         + torch.cos(p1) * torch.cos(p2) * torch.sin(0.5 * dl) ** 2)
    return 2.0 * radius * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


def count_needed(cols, active, rpz, hpz, tlook):
    """The number of ordered pairs of active aircraft that need the
    work (the tests above, on the mean earth radius)."""
    idx = torch.nonzero(active, as_tuple=True)[0]
    return sum(int(o.numel()) for o, _ in batched(needed(
        cols, idx, idx, rpz, hpz, tlook)))
