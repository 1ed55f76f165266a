"""Host-side geodesy: the compiled C core when a host compiler is found,
NumPy otherwise.

Port of ``bluesky_tpu/ops/hostgeo.py``.  It serves the host-side
consumers (the radar and ND pictures, navdb nearest queries, landing
checks, SO6, plugins) with the public surface of the JAX module; the
device math is ``ops/geo.py``.  This wrapper owns all broadcasting and
the scalar/matrix conventions and hands the C core
(``csrc/cgeo.cpp``) flat float64 arrays.

The C core has a plain ``extern "C"`` interface.  On first use (the
first read of ``compiled`` or the first call) it is compiled with the
host compiler (``g++``, else ``c++``; ``-O2 -shared -fPIC``) into
``bluesky_tpu_torch/_build/libcgeo_<hash>.so`` and loaded with
``ctypes``; the name carries a hash of the source and the flags, so an
edited source is rebuilt.  Which case happened is in ``status``:

* a compiler was found and the build loaded: ``compiled`` is True;
* no host compiler was found: ``compiled`` is False and every function
  runs the NumPy path, as the JAX module does without its extension;
* a compiler was found but the build failed: the read of ``compiled``
  (and any call) raises ``RuntimeError`` with the compiler's message.
  Nothing falls back quietly.

``compiled`` may be set to False to run the NumPy path (the tests hold
both paths against the JAX package).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

nm = 1852.0
A_WGS84 = 6378137.0
B_WGS84 = 6356752.314245
REARTH = 6371000.0

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "cgeo.cpp")
BUILD = os.path.join(_PKG, "_build")
FLAGS = ["-O2", "-shared", "-fPIC"]
#: host compilers tried in turn
COMPILERS = ("g++", "c++")

_P = ctypes.c_void_p        # a float64 array's address (``_call``)
_L = ctypes.c_long
#: ctypes signatures of the C entry points
SIGNATURES = {
    "cgeo_rwgs84": [_P, _L, _P],
    "cgeo_wgsg": [_P, _L, _P],
    "cgeo_qdrdist": [_P, _P, _P, _P, _L, ctypes.c_int, _P, _P],
    "cgeo_qdrpos": [_P, _P, _P, _P, _L, _P, _P],
    "cgeo_kwik": [_P, _P, _P, _P, _L, _P, _P],
}

_lock = threading.Lock()
_lib = None
#: how the core was chosen (set on first use)
status = "not loaded yet"


def find_compiler():
    """Path of the first host compiler of ``COMPILERS`` on PATH, or
    None."""
    for name in COMPILERS:
        path = shutil.which(name)
        if path:
            return path
    return None


def lib_path(compiler) -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(
            fh.read() + " ".join([os.path.basename(compiler)] + FLAGS)
            .encode())
    return os.path.join(BUILD, f"libcgeo_{digest.hexdigest()[:12]}.so")


def build(compiler) -> str:
    """Compile the core with ``compiler`` (if its library is missing)
    and return the library path.  The library is written under a
    temporary name and renamed into place, so several processes may
    build at once.  A failed build raises ``RuntimeError``."""
    out = lib_path(compiler)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        res = subprocess.run([compiler, *FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host compiler {compiler} failed to run on "
                           f"{SOURCE}: {e}") from e
    if res.returncode != 0 or not os.path.exists(tmp):
        raise RuntimeError(f"host compiler {compiler} failed on {SOURCE} "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    """The loaded C library, or None when no host compiler is found;
    raises when a compiler is found and the build fails."""
    global _lib, status
    with _lock:
        if _lib is None and status == "not loaded yet":
            cc = find_compiler()
            if cc is None:
                status = (f"no host compiler ({', '.join(COMPILERS)}) on "
                          "PATH: the NumPy path")
            else:
                path = build(cc)
                lib = ctypes.CDLL(path)
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = None
                _lib = lib
                status = f"compiled with {cc} into {path}"
        return _lib


def __getattr__(name):
    if name == "compiled":
        on = _load() is not None
        globals()["compiled"] = on
        return on
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _core():
    """The C library when the C path is on, else None."""
    on = globals().get("compiled")
    if on is None:
        on = __getattr__("compiled")
    return _load() if on else None


def _call(fn, ins, nout, *extra):
    """Run one C entry point over the flat inputs ``ins`` (equal-length
    contiguous float64, ``_flat``'s); returns ``nout`` new arrays.  The
    arrays stay referenced here while the C code runs."""
    n = ins[0].size
    outs = [np.empty(n, np.float64) for _ in range(nout)]
    fn(*[a.ctypes.data for a in ins], n, *extra,
       *[o.ctypes.data for o in outs])
    return outs


def _flat(*args):
    """Broadcast args to one shape; return flat f64 arrays + shape +
    scalar-ness."""
    if all(type(a) in (float, int) for a in args):     # the scalar calls
        return [np.array([a], np.float64) for a in args], ()
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


def _np_qdrpos(lat1, lon1, qdr, dist):
    R = _np_rwgs84(lat1) / nm
    lat1r, lon1r = np.radians(lat1), np.radians(lon1)
    dr, qdrr = dist / R, np.radians(qdr)
    lat2 = np.arcsin(np.sin(lat1r) * np.cos(dr)
                     + np.cos(lat1r) * np.sin(dr) * np.cos(qdrr))
    lon2 = lon1r + np.arctan2(
        np.sin(qdrr) * np.sin(dr) * np.cos(lat1r),
        np.cos(dr) - np.sin(lat1r) * np.sin(lat2))
    return np.degrees(lat2), np.degrees(lon2)


# ------------------------------------------------------------- public API
def rwgs84(latd):
    flat, shape = _flat(latd)
    lib = _core()
    out = _call(lib.cgeo_rwgs84, flat, 1)[0] if lib is not None \
        else _np_rwgs84(flat[0])
    return _unflat(out, shape)


def wgsg(latd):
    flat, shape = _flat(latd)
    lib = _core()
    if lib is not None:
        out = _call(lib.cgeo_wgsg, flat, 1)[0]
    else:
        s = np.sin(np.radians(flat[0]))
        out = 9.7803 * (1.0 + 0.001932 * s * s) \
            / np.sqrt(1.0 - 6.694e-3 * s * s)
    return _unflat(out, shape)


def _qdrdist_core(lat1, lon1, lat2, lon2, mode):
    flat, shape = _flat(lat1, lon1, lat2, lon2)
    lib = _core()
    if lib is not None:
        q, d = _call(lib.cgeo_qdrdist, flat, 2, mode)
    else:
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
    lib = _core()
    la, lo = _call(lib.cgeo_qdrpos, flat, 2) if lib is not None \
        else _np_qdrpos(*flat)
    return _unflat(la, shape), _unflat(lo, shape)


def _kwik_core(lat1, lon1, lat2, lon2):
    flat, shape = _flat(lat1, lon1, lat2, lon2)
    lib = _core()
    q, d = _call(lib.cgeo_kwik, flat, 2) if lib is not None \
        else _np_kwik(*flat)
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
