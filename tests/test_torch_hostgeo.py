"""The port's host geodesy (``bluesky_tpu_torch/ops/hostgeo.py`` and its
C core ``csrc/cgeo.cpp``; ROADMAP A10.9) against the JAX package's, on
the CPU.

* Both paths of the port (the C core built with the host compiler, and
  NumPy with ``compiled`` set to False) against JAX's public functions
  and against JAX's ``_np_*`` NumPy core, on numpy-seeded points with
  same-point, equator and antimeridian cases (those of
  ``tests/test_hostgeo.py``), in the scalar and the matrix forms:
  within 1e-12 relative, or 1e-9 absolute for a pair that coincides.
  JAX's own C extension is ignored by git and may be unbuilt: the port
  is held against whichever core JAX loads.
* Scalars come back as Python floats on both paths.
* How the core is chosen: a host compiler builds and loads the
  library under ``_build/`` with the source and flags hash in its
  name; no compiler gives the NumPy path and says so; a compiler that
  is found but fails raises, on the read of ``compiled`` and on a
  call, and never falls back.
"""
import os

import numpy as np
import pytest

from bluesky_tpu.ops import hostgeo as jhg
from bluesky_tpu_torch.ops import hostgeo as thg

RTOL, ATOL_SAME = 1e-12, 1e-9


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(7)
    n = 500
    lat1 = rng.uniform(-85, 85, n)
    lon1 = rng.uniform(-180, 180, n)
    lat2 = rng.uniform(-85, 85, n)
    lon2 = rng.uniform(-180, 180, n)
    # same-point, equator and antimeridian cases
    lat2[:5], lon2[:5] = lat1[:5], lon1[:5]
    lat1[5] = 0.0
    lon1[6], lon2[6] = 179.9, -179.9
    return lat1, lon1, lat2, lon2


@pytest.fixture(params=["compiled", "numpy"])
def port(request, monkeypatch):
    """The port's module on one of its two paths."""
    assert thg.compiled, thg.status     # a compiler is on this machine
    if request.param == "numpy":
        monkeypatch.setattr(thg, "compiled", False)
    return thg


def close(got, want, same=None):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    d = np.abs(got - want)
    ok = d <= RTOL * np.abs(want)
    if same is not None:
        ok |= np.broadcast_to(same, d.shape) & (d <= ATOL_SAME)
    assert ok.all(), (float(d[~ok].max()), np.flatnonzero(~ok.ravel())[:8])


def test_vector_forms_against_jax(port, pts):
    lat1, lon1, lat2, lon2 = pts
    same = (lat1 == lat2) & (lon1 == lon2)
    close(port.rwgs84(lat1), jhg.rwgs84(lat1))
    close(port.wgsg(lat1), jhg.wgsg(lat1))
    for fn in ("qdrdist", "kwikqdrdist"):
        for g, w in zip(getattr(port, fn)(lat1, lon1, lat2, lon2),
                        getattr(jhg, fn)(lat1, lon1, lat2, lon2)):
            close(g, w, same)
    for fn in ("latlondist", "kwikdist", "kwikdist_wrapped"):
        close(getattr(port, fn)(lat1, lon1, lat2, lon2),
              getattr(jhg, fn)(lat1, lon1, lat2, lon2), same)
    qdr = np.random.default_rng(1).uniform(0, 360, lat1.size)
    dist = np.random.default_rng(2).uniform(0, 500, lat1.size)
    for g, w in zip(port.qdrpos(lat1, lon1, qdr, dist),
                    jhg.qdrpos(lat1, lon1, qdr, dist)):
        close(g, w)


def test_matrix_forms_against_jax(port, pts):
    s = slice(0, 40)
    lat1, lon1, lat2, lon2 = (a[s] for a in pts)
    same = (lat1[:, None] == lat2[None, :]) & (lon1[:, None] == lon2[None, :])
    for fn in ("qdrdist_matrix", "kwikqdrdist_matrix"):
        for g, w in zip(getattr(port, fn)(lat1, lon1, lat2, lon2),
                        getattr(jhg, fn)(lat1, lon1, lat2, lon2)):
            close(g, w, same)
    for fn in ("latlondist_matrix", "kwikdist_matrix"):
        close(getattr(port, fn)(lat1, lon1, lat2, lon2),
              getattr(jhg, fn)(lat1, lon1, lat2, lon2), same)


def test_against_jax_numpy_core(port, pts):
    """The port's cores against JAX's ``_np_*`` functions (the path JAX
    takes without its extension), modes 0 and 1 of the mean radius."""
    lat1, lon1, lat2, lon2 = pts
    same = (lat1 == lat2) & (lon1 == lon2)
    close(port.rwgs84(lat1), jhg._np_rwgs84(lat1))
    for mode in (0, 1):
        for g, w in zip(port._qdrdist_core(lat1, lon1, lat2, lon2, mode),
                        jhg._np_qdrdist(lat1, lon1, lat2, lon2, mode)):
            close(g, w, same)
    for g, w in zip(port.kwikqdrdist(lat1, lon1, lat2, lon2),
                    jhg._np_kwik(lat1, lon1, lat2, lon2)):
        close(g, w, same)


@pytest.mark.parametrize("fn,args", [
    ("rwgs84", (52.0,)), ("wgsg", (52.0,)),
    ("qdrdist", (52.0, 4.0, 53.0, 5.0)), ("latlondist", (0.0, 0.0, 0.0, 1.0)),
    ("qdrpos", (52.0, 4.0, 90.0, 10.0)), ("kwikdist", (52.0, 4.0, 52.0, 4.0)),
    ("kwikqdrdist", (-10.0, 179.9, -10.5, -179.9)),
    ("kwikdist_wrapped", (-10.0, 179.9, -10.5, -179.9))])
def test_scalars_stay_scalars(port, fn, args):
    got, want = getattr(port, fn)(*args), getattr(jhg, fn)(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert isinstance(g, float)
        close(g, w, same=np.array(args[:2] == args[2:4]))


def test_core_is_built_under_build_with_its_hash():
    assert thg.compiled
    assert thg.status.startswith("compiled with ")
    path = thg.lib_path(thg.find_compiler())
    assert os.path.dirname(path) == thg.BUILD and os.path.exists(path)
    assert path in thg.status


def _fresh(monkeypatch, compiler):
    """The module as if never loaded, finding ``compiler`` (loaded for
    real first, so that the test's end restores the real core)."""
    assert thg.compiled
    monkeypatch.setattr(thg, "_lib", None)
    monkeypatch.setattr(thg, "status", "not loaded yet")
    monkeypatch.delattr(thg, "compiled", raising=False)
    monkeypatch.setattr(thg, "find_compiler", lambda: compiler)


def test_no_compiler_takes_the_numpy_path(monkeypatch, pts):
    _fresh(monkeypatch, None)
    assert thg.compiled is False
    assert "NumPy path" in thg.status
    lat1, lon1, lat2, lon2 = pts
    q, d = thg.qdrdist(lat1, lon1, lat2, lon2)
    jq, jd = jhg._np_qdrdist(lat1, lon1, lat2, lon2, 0)
    assert np.array_equal(q, jq) and np.array_equal(d, jd / jhg.nm)


def test_a_failing_compiler_raises(monkeypatch, tmp_path):
    failing = tmp_path / "cc"
    failing.write_text("#!/bin/sh\necho 'cc: broken toolchain' >&2\n"
                       "exit 3\n")
    failing.chmod(0o755)
    _fresh(monkeypatch, str(failing))
    with pytest.raises(RuntimeError, match="broken toolchain"):
        thg.compiled
    with pytest.raises(RuntimeError, match="exit 3"):
        thg.qdrdist(52.0, 4.0, 53.0, 5.0)
    assert "compiled" not in vars(thg)      # nothing fell back
    assert not os.path.exists(thg.lib_path(str(failing)))
