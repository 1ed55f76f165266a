"""The device forms of the reference's fast flat-earth geodesy and of
the crossover altitude (``ops/geo.kwikdist``, ``kwikdist_matrix``,
``kwikqdrdist``, ``kwikqdrdist_matrix``, ``kwikpos``, ``wgsg`` and
``ops/aero.crossoveralt``, ROADMAP A10.1) on float64 tensors, against the
JAX package's functions on the same inputs, and the properties JAX's
``tests/test_geo.py`` and ``tests/test_aero.py`` hold them to.  The
functions are elementwise: equal to JAX's within a few ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.ops import aero as jaero, geo as jgeo
from bluesky_tpu_torch.ops import aero, geo

RTOL = 1e-13


def points(n=64, seed=0):
    """Pairs of positions: random ones, a few across the antimeridian (the
    reference's unwrapped longitude, kept as JAX keeps it) and poles."""
    rng = np.random.default_rng(seed)
    lat1, lat2 = rng.uniform(-85, 85, (2, n))
    lon1, lon2 = rng.uniform(-180, 180, (2, n))
    lon1[:4], lon2[:4] = 179.5, -179.5
    lat1[4:6] = 90.0
    return lat1, lon1, lat2, lon2


def both(name, *args, mod=(jgeo, geo)):
    """``name`` of the JAX module and of the port's on the same float64
    arrays, as numpy tuples."""
    j = getattr(mod[0], name)(*[jnp.asarray(a) for a in args])
    t = getattr(mod[1], name)(*[torch.from_numpy(np.asarray(a))
                                for a in args])
    tup = lambda r: r if isinstance(r, tuple) else (r,)
    return ([np.asarray(a) for a in tup(j)],
            [a.numpy() for a in tup(t)])


@pytest.mark.parametrize("name", ["kwikdist", "kwikqdrdist",
                                  "kwikdist_matrix", "kwikqdrdist_matrix"])
def test_kwik_forms_match_jax(name):
    js, ts = both(name, *points())
    for j, t in zip(js, ts):
        assert t.dtype == np.float64
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-9)
    if name.endswith("matrix"):
        assert ts[0].shape == (64, 64)


def test_kwikpos_and_wgsg_match_jax():
    rng = np.random.default_rng(1)
    lat, lon = rng.uniform(-89, 89, 64), rng.uniform(-180, 180, 64)
    lat[0] = 90.0                       # the 0.01 floor of the cosine
    qdr, dist = rng.uniform(0, 360, 64), rng.uniform(0, 500, 64)
    for j, t in zip(*both("kwikpos", lat, lon, qdr, dist)):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-9)
    for j, t in zip(*both("wgsg", lat)):
        np.testing.assert_allclose(t, j, rtol=RTOL)


def test_crossoveralt_matches_jax():
    rng = np.random.default_rng(2)
    cas, mach = rng.uniform(100, 180, 64), rng.uniform(0.6, 0.85, 64)
    (j,), (t,) = both("crossoveralt", cas, mach, mod=(jaero, aero))
    np.testing.assert_allclose(t, j, rtol=RTOL)


def test_jax_test_properties_hold():
    """JAX's ``tests/test_geo.py`` and ``test_aero.py`` cases on tensors."""
    T = lambda *a: [torch.tensor(float(x), dtype=torch.float64) for x in a]
    _, d_exact = geo.qdrdist(*T(52.0, 4.0, 52.2, 4.3))
    assert float(geo.kwikdist(*T(52.0, 4.0, 52.2, 4.3))) == pytest.approx(
        float(d_exact), rel=2e-3)
    _, d_m = geo.kwikqdrdist(*T(52.0, 4.0, 52.2, 4.3))
    assert float(d_m) == pytest.approx(float(d_exact) * 1852.0, rel=2e-3)
    assert float(geo.wgsg(*T(0.0))) == pytest.approx(9.7803, abs=1e-4)
    assert float(geo.wgsg(*T(90.0))) > float(geo.wgsg(*T(0.0)))
    lat2, lon2 = geo.kwikpos(*T(52.0, 4.0, 90.0, 60.0))
    assert float(lat2) == pytest.approx(52.0, abs=1e-6)
    assert float(lon2) == pytest.approx(
        4.0 + 1.0 / np.cos(np.radians(52.0)), rel=1e-6)
    cas, mach = T(150.0, 0.78)
    hx = aero.crossoveralt(cas, mach)
    assert 5000.0 < float(hx) < 15000.0
    assert float(aero.vcas2tas(cas, hx)) == pytest.approx(
        float(aero.vmach2tas(mach, hx)), rel=5e-3)
