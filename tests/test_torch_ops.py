"""The port's elementwise and tile math against the JAX package, on the
same numpy-seeded inputs: aero, kmath, geo, the cd_tiled geometry and
reachability bound, and the MVP pair math, resolution tail and resume
keep predicate.

Float64 at rtol 1e-12 (the two packages evaluate the same formulas; the
bound leaves room for libm ulps in exp/pow/atan2), kmath also in float32
at rtol 2e-6 (a few f32 ulps), boolean outputs exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.ops import aero as jaero, cd_tiled as jtiled, \
    cr_mvp as jmvp, geo as jgeo, kmath as jkmath
from bluesky_tpu_torch.ops import aero, cd_tiled, cr_mvp, geo, kmath

from torch_parity import FT, NM

RTOL64 = 1e-12


def pair(a, dtype=np.float64):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def close(t, j, rtol=RTOL64, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("name", [
    "vtemp", "vpressure", "vdensity", "vvsound", "vtas2mach", "vmach2tas",
    "veas2tas", "vtas2eas", "vcas2tas", "vtas2cas", "vmach2cas",
    "vcas2mach", "vcasormach2tas"])
def test_aero(rng, name):
    h = rng.uniform(-200.0, 20000.0, 500)
    spd = np.where(rng.random(500) < 0.3, rng.uniform(0.2, 0.95, 500),
                   rng.uniform(50.0, 300.0, 500))
    jf, tf = getattr(jaero, name), getattr(aero, name)
    hj, ht = pair(h)
    if name in ("vtemp", "vpressure", "vdensity", "vvsound"):
        close(tf(ht), jf(hj))
    else:
        sj, st = pair(spd)
        close(tf(st, ht), jf(sj, hj))


def test_aero_vatmos_vcasormach(rng):
    h = rng.uniform(0.0, 15000.0, 400)
    spd = np.where(rng.random(400) < 0.3, rng.uniform(0.2, 0.95, 400),
                   rng.uniform(50.0, 300.0, 400))
    hj, ht = pair(h)
    sj, st = pair(spd)
    for a, b in zip(aero.vatmos(ht), jaero.vatmos(hj)):
        close(a, b)
    for a, b in zip(aero.vcasormach(st, ht), jaero.vcasormach(sj, hj)):
        close(a, b)


@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, RTOL64, 1e-15),
                                             (np.float32, 2e-6, 1e-7)])
def test_kmath(rng, dtype, rtol, atol):
    x = np.concatenate([rng.uniform(-50, 50, 300), rng.uniform(-1, 1, 300),
                        [0.0, 1.0, -1.0, 0.41421356, 1e-8]])
    y = rng.uniform(-20, 20, x.size)
    xj, xt = pair(x, dtype)
    yj, yt = pair(y, dtype)
    close(kmath.atan(xt), jkmath.atan(xj), rtol, atol)
    close(kmath.atan2(yt, xt), jkmath.atan2(yj, xj), rtol, atol)
    close(kmath.atan2(yt * 0, xt), jkmath.atan2(yj * 0, xj), rtol, atol)
    s = np.clip(x / 50.0, -1, 1)
    sj, st = pair(s, dtype)
    close(kmath.asin(st), jkmath.asin(sj), rtol, atol)
    close(kmath.asin_taylor(torch.abs(st)), jkmath.asin_taylor(jnp.abs(sj)),
          rtol, atol)


def test_geo(rng):
    lat1, lat2 = rng.uniform(-80, 80, 300), rng.uniform(-80, 80, 300)
    lon1, lon2 = rng.uniform(-180, 180, 300), rng.uniform(-180, 180, 300)
    lat2[:50] = -lat1[:50]                  # hemisphere branch of the radius
    j = [pair(a)[0] for a in (lat1, lon1, lat2, lon2)]
    t = [pair(a)[1] for a in (lat1, lon1, lat2, lon2)]
    close(geo.rwgs84(t[0]), jgeo.rwgs84(j[0]))
    for a, b in zip(geo.qdrdist(*t), jgeo.qdrdist(*j)):
        close(a, b)


def _tile_inputs(rng, n, dtype=np.float64):
    lat = np.concatenate([rng.uniform(50, 53, n // 2),
                          rng.uniform(-1.5, 1.5, n - n // 2)])
    lat[3] = 0.0                            # the 1e-6 denominator guard
    lon = np.concatenate([rng.uniform(3, 7, n // 2),
                          rng.uniform(178, 182, n - n // 2)])
    lon = (lon + 180.0) % 360.0 - 180.0      # antimeridian wrap
    return pair(lat, dtype), pair(lon, dtype)


def test_cd_tiled_geometry(rng):
    (latj, latt), (lonj, lont) = _tile_inputs(rng, 64)
    tj, tt = jtiled.precompute_trig(latj, lonj), \
        cd_tiled.precompute_trig(latt, lont)
    assert tuple(tt) == tuple(tj) == cd_tiled.TRIG_FIELDS
    for k in cd_tiled.TRIG_FIELDS:
        close(tt[k], tj[k])
    oj = {k: v[None, :] for k, v in tj.items()}
    ij = {k: v[:, None] for k, v in tj.items()}
    ot = {k: v[None, :] for k, v in tt.items()}
    it = {k: v[:, None] for k, v in tt.items()}
    for a, b in zip(cd_tiled.tile_geometry(ot, it),
                    jtiled.tile_geometry(oj, ij)):
        close(a, b, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cd_tiled_reachability(rng, dtype):
    nb, block = 12, 16
    n = nb * block
    lat = rng.uniform(45, 60, n)
    lat[: 3 * block] = rng.uniform(-5, 5, 3 * block)
    lon = rng.uniform(-10, 30, n)
    gs = rng.uniform(100, 250, n)
    alt = rng.uniform(1000, 12000, n)
    vs = rng.uniform(-10, 10, n)
    active = rng.random(n) > 0.2
    active[5 * block:6 * block] = False      # an empty block
    j = [pair(a, dtype)[0] for a in (lat, lon, gs, alt, vs)]
    t = [pair(a, dtype)[1] for a in (lat, lon, gs, alt, vs)]
    actj, actt = jnp.asarray(active), torch.from_numpy(active)
    sj = jtiled.block_summaries(j[0], j[1], j[2], actj, nb, block,
                                alt=j[3], vs=j[4])
    st = cd_tiled.block_summaries(t[0], t[1], t[2], actt, nb, block,
                                  alt=t[3], vs=t[4])
    for k in sj:
        np.testing.assert_array_equal(np.asarray(st[k]), np.asarray(sj[k]))
    for kw in (dict(), dict(hpz=1000 * FT)):
        rj = jtiled.reachability_from_summaries(sj, sj, 5 * NM, 300.0, **kw)
        rt = cd_tiled.reachability_from_summaries(st, st, 5 * NM, 300.0,
                                                  **kw)
        np.testing.assert_array_equal(np.asarray(rt), np.asarray(rj))
    rj = jtiled.block_reachability(j[0], j[1], j[2], actj, nb, block,
                                   5 * NM, 120.0, alt=j[3], vs=j[4],
                                   hpz=1000 * FT)
    rt = cd_tiled.block_reachability(t[0], t[1], t[2], actt, nb, block,
                                     5 * NM, 120.0, alt=t[3], vs=t[4],
                                     hpz=1000 * FT)
    assert 0 < int(rt.sum()) < nb * nb
    np.testing.assert_array_equal(np.asarray(rt), np.asarray(rj))


def _mvp_cfg(mod, **kw):
    return mod.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                         tlookahead=300.0, **kw)


def test_cr_mvp_pair_contrib_trig(rng):
    n = 2000
    q = rng.uniform(0, 2 * np.pi, n)
    dist = np.concatenate([rng.uniform(0, 3 * 5 * NM, n - 10),
                           np.zeros(10)])
    tcpa = rng.uniform(-100, 400, n)
    tcpa[:5] = 0.0
    tlos = rng.uniform(0, 300, n)
    dalt = rng.uniform(-600, 600, n)
    ve, vn = rng.uniform(-400, 400, n), rng.uniform(-400, 400, n)
    vv = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(-20, 20, n))
    args = [np.sin(q), np.cos(q), dist, tcpa, tlos, dalt, ve, vn, vv]
    outj = jmvp.pair_contrib_trig(*[pair(a)[0] for a in args],
                                  _mvp_cfg(jmvp))
    outt = cr_mvp.pair_contrib_trig(*[pair(a)[1] for a in args],
                                    _mvp_cfg(cr_mvp))
    for a, b in zip(outt, outj):
        close(a, b, atol=1e-9)


@pytest.mark.parametrize("mode", [dict(), dict(swresohoriz=True),
                                  dict(swresohoriz=True, swresospd=True),
                                  dict(swresohoriz=True, swresohdg=True),
                                  dict(swresovert=True)])
def test_cr_mvp_resolve_from_sums(rng, mode):
    n = 500
    cols = dict(
        sum_dve=rng.normal(0, 20, n), sum_dvn=rng.normal(0, 20, n),
        sum_dvv=rng.normal(0, 3, n),
        tsolv=np.where(rng.random(n) < 0.5, rng.uniform(0, 400, n), 1e9),
        alt=rng.uniform(3000, 11000, n), gseast=rng.uniform(-240, 240, n),
        gsnorth=rng.uniform(-240, 240, n), vs=rng.uniform(-10, 10, n),
        trk=rng.uniform(0, 360, n), gs=rng.uniform(100, 250, n),
        selalt=rng.uniform(3000, 11000, n), ap_vs=rng.uniform(-10, 10, n),
        prev_alt=rng.uniform(3000, 11000, n))
    cols["sum_dve"][:20] = 0.0
    cols["sum_dvn"][:20] = 0.0
    resooff = rng.random(n) < 0.1
    caps = (100 * 0.514444, 180 * 0.514444, -3000 * FT / 60, 3000 * FT / 60)
    outj = jmvp.resolve_from_sums(*[pair(a)[0] for a in cols.values()],
                                  *caps, _mvp_cfg(jmvp, **mode),
                                  resooff=jnp.asarray(resooff))
    outt = cr_mvp.resolve_from_sums(*[pair(a)[1] for a in cols.values()],
                                    *caps, _mvp_cfg(cr_mvp, **mode),
                                    resooff=torch.from_numpy(resooff))
    for a, b in zip(outt, outj):
        close(a, b, atol=1e-9)


def test_cr_mvp_resume_keep_core(rng):
    n = 3000
    de, dn = rng.uniform(-2e4, 2e4, n), rng.uniform(-2e4, 2e4, n)
    ve, vn = rng.uniform(-300, 300, n), rng.uniform(-300, 300, n)
    ti, tj = rng.uniform(0, 360, n), rng.uniform(0, 360, n)
    tj[:500] = ti[:500] + rng.uniform(-40, 40, 500)
    alive = rng.random(n) < 0.9
    args = [de, dn, ve, vn, ti, tj]
    kj = jmvp.resume_keep_core(*[pair(a)[0] for a in args],
                               jnp.asarray(alive), 5 * NM, 5 * NM * 1.05)
    kt = cr_mvp.resume_keep_core(*[pair(a)[1] for a in args],
                                 torch.from_numpy(alive), 5 * NM,
                                 5 * NM * 1.05)
    assert 0 < int(kt.sum()) < n
    np.testing.assert_array_equal(np.asarray(kt), np.asarray(kj))
