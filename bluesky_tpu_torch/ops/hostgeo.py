"""Host-side geodesy in NumPy (float64).

Port of ``bluesky_tpu/ops/hostgeo.py``, its NumPy path only (the port
builds no host C extension).  It serves the host-side consumers (navdb
nearest queries, landing checks) with the public surface of the JAX
module; the device math is ``ops/geo.py``.
"""
import numpy as np

nm = 1852.0
A_WGS84 = 6378137.0
B_WGS84 = 6356752.314245
REARTH = 6371000.0


def _flat(*args):
    """Broadcast args to one shape; return flat f64 arrays + shape +
    scalar-ness."""
    arrs = np.broadcast_arrays(*[np.asarray(a, np.float64) for a in args])
    shape = arrs[0].shape
    return [np.ascontiguousarray(a).ravel() for a in arrs], shape


def _unflat(flatval, shape):
    out = np.asarray(flatval).reshape(shape)
    return float(out) if shape == () else out


# ------------------------------------------------------------ NumPy core
def _np_rwgs84(latd):
    lat = np.radians(latd)
    coslat, sinlat = np.cos(lat), np.sin(lat)
    an = A_WGS84 * A_WGS84 * coslat
    bn = B_WGS84 * B_WGS84 * sinlat
    ad = A_WGS84 * coslat
    bd = B_WGS84 * sinlat
    return np.sqrt((an * an + bn * bn) / (ad * ad + bd * bd))


def _np_mean_radius(lat1, lat2, mode):
    r1, r2 = _np_rwgs84(lat1), _np_rwgs84(lat2)
    if mode == 0:
        res1 = _np_rwgs84(0.5 * (lat1 + lat2))
        denom = np.maximum(np.abs(lat1) + np.abs(lat2), 1e-30)
        res2 = 0.5 * (np.abs(lat1) * (r1 + A_WGS84)
                      + np.abs(lat2) * (r2 + A_WGS84)) / denom
        return np.where(lat1 * lat2 >= 0.0, res1, res2)
    res1 = _np_rwgs84(lat1 + lat2)
    denom = np.abs(lat1) + np.abs(lat2) + np.where(lat1 == 0.0, 1e-6, 0.0)
    res2 = 0.5 * (np.abs(lat1) * (r1 + A_WGS84)
                  + np.abs(lat2) * (r2 + A_WGS84)) / denom
    return np.where(lat1 * lat2 < 0.0, res2, res1)


def _np_qdrdist(lat1d, lon1d, lat2d, lon2d, mode):
    r = _np_mean_radius(lat1d, lat2d, mode)
    lat1, lon1 = np.radians(lat1d), np.radians(lon1d)
    lat2, lon2 = np.radians(lat2d), np.radians(lon2d)
    s1 = np.sin(0.5 * (lat2 - lat1))
    s2 = np.sin(0.5 * (lon2 - lon1))
    c1, c2 = np.cos(lat1), np.cos(lat2)
    root = s1 * s1 + c1 * c2 * s2 * s2
    d = 2.0 * r * np.arctan2(np.sqrt(root), np.sqrt(1.0 - root))
    qdr = np.degrees(np.arctan2(
        np.sin(lon2 - lon1) * c2,
        c1 * np.sin(lat2) - np.sin(lat1) * c2 * np.cos(lon2 - lon1)))
    return qdr, d


def _np_kwik(lat1, lon1, lat2, lon2):
    dlat = np.radians(lat2 - lat1)
    dlon = np.radians(lon2 - lon1)
    cav = np.cos(np.radians(lat1 + lat2) * 0.5)
    dist = REARTH * np.sqrt(dlat * dlat + dlon * dlon * cav * cav)
    qdr = np.degrees(np.arctan2(dlon * cav, dlat)) % 360.0
    return qdr, dist


# ------------------------------------------------------------- public API
def rwgs84(latd):
    flat, shape = _flat(latd)
    out = _np_rwgs84(flat[0])
    return _unflat(out, shape)


def wgsg(latd):
    flat, shape = _flat(latd)
    s = np.sin(np.radians(flat[0]))
    out = 9.7803 * (1.0 + 0.001932 * s * s) / np.sqrt(1.0 - 6.694e-3 * s * s)
    return _unflat(out, shape)


def _qdrdist_core(lat1, lon1, lat2, lon2, mode):
    flat, shape = _flat(lat1, lon1, lat2, lon2)
    q, d = _np_qdrdist(*flat, mode)
    return _unflat(q, shape), _unflat(d, shape)


def qdrdist(lat1, lon1, lat2, lon2):
    """Bearing [deg], distance [nm] (scalar mean-radius semantics)."""
    q, d = _qdrdist_core(lat1, lon1, lat2, lon2, 0)
    return q, d / nm


def latlondist(lat1, lon1, lat2, lon2):
    """Distance [m] (scalar semantics)."""
    return _qdrdist_core(lat1, lon1, lat2, lon2, 0)[1]


def qdrdist_matrix(lat1, lon1, lat2, lon2):
    """All-pairs bearing [deg] / distance [nm] (matrix radius quirk)."""
    q, d = _qdrdist_core(np.asarray(lat1)[:, None], np.asarray(lon1)[:, None],
                         np.asarray(lat2)[None, :], np.asarray(lon2)[None, :],
                         1)
    return q, d / nm


def latlondist_matrix(lat1, lon1, lat2, lon2):
    """All-pairs distance [nm] (reference returns nm here)."""
    return qdrdist_matrix(lat1, lon1, lat2, lon2)[1]


def qdrpos(lat1, lon1, qdr, dist):
    """Project position: bearing [deg] + distance [nm] -> lat2, lon2."""
    flat, shape = _flat(lat1, lon1, qdr, dist)
    R = _np_rwgs84(flat[0]) / nm
    lat1r, lon1r = np.radians(flat[0]), np.radians(flat[1])
    dr, qdrr = flat[3] / R, np.radians(flat[2])
    lat2 = np.arcsin(np.sin(lat1r) * np.cos(dr)
                     + np.cos(lat1r) * np.sin(dr) * np.cos(qdrr))
    lon2 = lon1r + np.arctan2(
        np.sin(qdrr) * np.sin(dr) * np.cos(lat1r),
        np.cos(dr) - np.sin(lat1r) * np.sin(lat2))
    la, lo = np.degrees(lat2), np.degrees(lon2)
    return _unflat(la, shape), _unflat(lo, shape)


def _kwik_core(lat1, lon1, lat2, lon2):
    flat, shape = _flat(lat1, lon1, lat2, lon2)
    q, d = _np_kwik(*flat)
    return _unflat(q, shape), _unflat(d, shape)


def kwikdist(lat1, lon1, lat2, lon2):
    """Flat-earth distance [nm]."""
    return _kwik_core(lat1, lon1, lat2, lon2)[1] / nm


def kwikdist_matrix(lat1, lon1, lat2, lon2):
    return kwikdist(np.asarray(lat1)[:, None], np.asarray(lon1)[:, None],
                    np.asarray(lat2)[None, :], np.asarray(lon2)[None, :])


def kwikdist_wrapped(lat1, lon1, lat2, lon2):
    """Flat-earth distance [nm] with the longitude difference wrapped to
    [-180, 180) — the antimeridian-safe variant host consumers use
    (ops/geo.kwikdist_wrapped)."""
    lon1 = np.asarray(lon1, np.float64)
    lon2w = lon1 + (((np.asarray(lon2, np.float64) - lon1) + 180.0)
                    % 360.0 - 180.0)
    return kwikdist(lat1, lon1, lat2, lon2w)


def kwikqdrdist(lat1, lon1, lat2, lon2):
    """Flat-earth bearing [deg, 0..360) and distance [m] (NB: metres,
    like the reference)."""
    return _kwik_core(lat1, lon1, lat2, lon2)


def kwikqdrdist_matrix(lat1, lon1, lat2, lon2):
    return kwikqdrdist(np.asarray(lat1)[:, None], np.asarray(lon1)[:, None],
                       np.asarray(lat2)[None, :], np.asarray(lon2)[None, :])
