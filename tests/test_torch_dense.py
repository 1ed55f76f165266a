"""The port's dense CD&R path against the JAX package, in float64, on
numpy-seeded inputs: the all-pairs geodesy (``geo.qdrdist_matrix``,
``latlondist_matrix``, ``qdrpos``), ``cd.detect`` (also against the
independent NumPy oracle ``tests/ref_numpy.py``), ``cr_mvp.resolve``
with NORESO/RESOOFF under every priority rule and resolution option,
``resume_nav``, and ``asas.update`` / ``detect_only`` over three
intervals.

Tolerances: flags and counts equal; the geodesy at rtol 1e-12 (the same
formulas; libm ulps in sin/cos/atan2); the pair matrices of ``detect``
and the MVP commands at rtol 1e-10 with an absolute floor for the
quantities that cancel (dcpa2 = dist^2 - tcpa^2 dv2 within 1e-4 m^2, the
velocity commands within 1e-8 m/s).  Measured: the pair matrices agree
to 3e-12 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import asas as jasas
from bluesky_tpu.ops import cd as jcd, cr_mvp as jmvp, geo as jgeo
from bluesky_tpu_torch.core import asas as tasas
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.ops import cd as tcd, cr_mvp as tmvp, geo as tgeo

import ref_numpy
from torch_parity import FT, NM, build_pair, jax_tree_to_numpy

RPZ, HPZ, TLOOK = 5.0 * NM, 1000.0 * FT, 300.0
NMAX, N = 128, 100


def columns(geom, seed=1, n=N, nmax=NMAX, all_active=False):
    """CD inputs [lat, lon, trk, gs, alt, vs, active] of a dense clump:
    ``box`` near 52 N, ``equator`` across it with three aircraft at lat 0;
    padding slots past ``n`` and four inactive slots among the live."""
    rng = np.random.default_rng(seed)
    if geom == "equator":
        lat = rng.uniform(-0.4, 0.4, n)
        lat[:3] = 0.0
    else:
        lat = rng.uniform(51.8, 52.3, n)
    lon = rng.uniform(3.8, 4.4, n)
    trk = rng.uniform(0.0, 360.0, n)
    gs = rng.uniform(150.0, 250.0, n)
    alt = rng.uniform(3000.0, 3300.0, n)
    vs = rng.uniform(-3.0, 3.0, n)
    vs[::3] = 0.0                           # cruisers for the priority rules
    pad = lambda a: np.concatenate([a, np.zeros(nmax - n)])
    active = np.zeros(nmax, bool)
    active[:n] = True
    if not all_active:
        active[5:9] = False
    return [pad(a) for a in (lat, lon, trk, gs, alt, vs)] + [active]


def both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a, copy=True)) for a in arrs])


def close(t, j, rtol=1e-10, atol=0.0, mask=None, err=""):
    t, j = np.asarray(t), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=err)


@pytest.mark.parametrize("geom", ["box", "equator"])
def test_qdrdist_matrix(geom):
    lat, lon = columns(geom)[:2]
    (jl, jo), (tl, to) = both([lat, lon])
    jq, jd = jgeo.qdrdist_matrix(jl, jo, jl, jo)
    tq, td = tgeo.qdrdist_matrix(tl, to, tl, to)
    close(tq, jq, rtol=1e-12, atol=1e-12)
    close(td, jd, rtol=1e-12, atol=1e-12)
    close(tgeo.latlondist_matrix(tl, to, tl, to),
          jgeo.latlondist_matrix(jl, jo, jl, jo), rtol=1e-12, atol=1e-12)
    if geom == "equator":
        # the lat == 0 rows take the 1e-6 epsilon of the radius quirk
        assert (lat[:3] == 0.0).all()
    rng = np.random.default_rng(3)
    qdr, dist = rng.uniform(0, 360, NMAX), rng.uniform(0, 200, NMAX)
    (jb, jdist), (tb, tdist) = both([qdr, dist])
    for a, b in zip(tgeo.qdrpos(tl, to, tb, tdist),
                    jgeo.qdrpos(jl, jo, jb, jdist)):
        close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("geom", ["box", "equator"])
def test_detect(geom):
    c = columns(geom)
    jc, tc = both(c)
    j = jcd.detect(*jc, RPZ, HPZ, TLOOK)
    t = tcd.detect(*tc, RPZ, HPZ, TLOOK)
    act = c[6]
    pairmask = act[:, None] & act[None, :] & ~np.eye(NMAX, dtype=bool)
    assert int(np.asarray(j.swconfl).sum()) > 0
    assert int(np.asarray(j.swlos).sum()) > 0
    for k in ("swconfl", "swlos", "inconf"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    assert not t.swconfl.numpy()[~pairmask].any()
    close(t.tcpamax, j.tcpamax, atol=1e-9, err="tcpamax")
    for k in ("qdr", "dist", "tcpa", "tinconf", "toutconf"):
        close(getattr(t, k), getattr(j, k), atol=1e-6, mask=pairmask, err=k)
    close(t.dcpa2, j.dcpa2, atol=1e-4, mask=pairmask, err="dcpa2")
    # excluded pairs carry the 1e9 offsets in both
    close(t.dist, j.dist, rtol=1e-12, mask=~pairmask, err="excluded dist")


def test_detect_against_numpy_oracle():
    c = columns("box", seed=4, all_active=True, nmax=N)
    t = tcd.detect(*both(c)[1], RPZ, HPZ, TLOOK)
    r = ref_numpy.detect(*c[:6], RPZ, HPZ, TLOOK)
    assert r["swconfl"].sum() > 0
    for k in ("swconfl", "swlos", "inconf"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), r[k], err_msg=k)
    close(t.tcpamax, r["tcpamax"], atol=1e-9)
    off = ~np.eye(N, dtype=bool)
    for k in ("qdr", "dist", "tcpa", "tinconf", "toutconf"):
        close(getattr(t, k), r[k], atol=1e-6, mask=off, err=k)
    assert tcd.pairs_from_mask(t.swconfl, [f"AC{i}" for i in range(N)]) \
        == [(f"AC{i}", f"AC{j}") for i, j in zip(*np.nonzero(r["swconfl"]))]


#: the resolver options held against JAX: (swprio, priocode) and the
#: resolution-direction switches
RESOLVE_CASES = {
    "prio-off": {},
    "FF1": dict(swprio=True, priocode="FF1"),
    "FF2": dict(swprio=True, priocode="FF2"),
    "FF3": dict(swprio=True, priocode="FF3"),
    "LAY1": dict(swprio=True, priocode="LAY1"),
    "LAY2": dict(swprio=True, priocode="LAY2"),
    "horiz": dict(swresohoriz=True),
    "horiz-spd": dict(swresohoriz=True, swresospd=True),
    "horiz-hdg": dict(swresohoriz=True, swresohdg=True),
    "vert": dict(swresovert=True),
}


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolve(case):
    c = columns("box", seed=2)
    rng = np.random.default_rng(7)
    trk, gs = np.radians(c[2]), c[3]
    extra = [gs * np.sin(trk), gs * np.cos(trk),
             c[4] + rng.uniform(-300, 300, NMAX),        # selalt
             rng.uniform(-5, 5, NMAX),                    # ap vs
             c[4] + rng.uniform(-100, 100, NMAX),        # previous alt
             rng.random(NMAX) < 0.1, rng.random(NMAX) < 0.1]  # noreso, off
    (jc, jx), (tc, tx) = [(a[:7], a[7:]) for a in both(c + extra)]
    jcfg = jmvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                          tlookahead=TLOOK, **RESOLVE_CASES[case])
    tcfg = tmvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                          tlookahead=TLOOK, **RESOLVE_CASES[case])
    lim = (100.0 * 0.514444, 180.0 * 0.514444, -15.24, 15.24)

    def run(mod, cd, cols, x, cfg):
        return mod.resolve(cd, cols[4], x[0], x[1], cols[5], cols[2],
                           cols[3], x[2], x[3], x[4], *lim, cfg,
                           noreso=x[5], resooff=x[6])
    jo = run(jmvp, jcd.detect(*jc, RPZ, HPZ, TLOOK), jc, jx, jcfg)
    to = run(tmvp, tcd.detect(*tc, RPZ, HPZ, TLOOK), tc, tx, tcfg)
    inconf = np.asarray(jcd.detect(*jc, RPZ, HPZ, TLOOK).inconf)
    assert inconf.sum() > 10
    for name, a, b in zip(("trk", "gs", "vs", "alt", "asase", "asasn"),
                          to, jo):
        close(a, b, atol=1e-8, err=name)


def test_resume_nav():
    c = columns("box", seed=5)
    rng = np.random.default_rng(9)
    trk, gs = np.radians(c[2]), c[3]
    pairs = rng.random((NMAX, NMAX)) < 0.3
    arrs = [pairs, c[0], c[1], gs * np.sin(trk), gs * np.cos(trk), c[2], c[6]]
    ja, ta = both(arrs)
    jp, jact = jmvp.resume_nav(ja[0], None, *ja[1:], RPZ, RPZ * 1.05)
    tp, tact = tmvp.resume_nav(*ta, RPZ, RPZ * 1.05)
    assert 0 < int(tp.sum()) < int(pairs.sum())
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))


def _move(js, ts, dt):
    """Advance both states' positions ``dt`` seconds along their ground
    speed (flat earth), with the same numpy values."""
    lat, lon = np.asarray(js.ac.lat), np.asarray(js.ac.lon)
    gsn, gse = np.asarray(js.ac.gsnorth), np.asarray(js.ac.gseast)
    lat2 = lat + gsn * dt / 111320.0
    lon2 = lon + gse * dt / (111320.0 * np.cos(np.radians(lat)))
    js = js.replace(ac=js.ac.replace(lat=jnp.asarray(lat2),
                                     lon=jnp.asarray(lon2)))
    ts = ts.replace(ac=ts.ac.replace(lat=torch.from_numpy(lat2.copy()),
                                     lon=torch.from_numpy(lon2.copy())))
    return js, ts


@pytest.mark.parametrize("reso_on", [True, False])
def test_update_three_intervals(reso_on):
    """``asas.update`` three times, the fleet moved 20 s between them so
    resume-nav releases pairs; then ``detect_only`` on the last state."""
    js, ts = build_pair(64, 60, geom="clump", seed=3, dtype="float64",
                        pair_matrix=True)
    noreso = np.zeros(64, bool)
    noreso[[3, 17]] = True
    resooff = np.zeros(64, bool)
    resooff[[5, 40]] = True
    js = js.replace(asas=js.asas.replace(noreso=jnp.asarray(noreso),
                                         resooff=jnp.asarray(resooff)))
    ts = ts.replace(asas=ts.asas.replace(noreso=torch.from_numpy(noreso),
                                         resooff=torch.from_numpy(resooff)))
    jcfg = jasas.AsasConfig(reso_on=reso_on, swprio=True, priocode="FF3")
    tcfg = tasas.AsasConfig(reso_on=reso_on, swprio=True, priocode="FF3")
    released = 0
    for k in range(3):
        js, _ = jasas.update(js, jcfg)
        ts, _ = tasas.update(ts, tcfg)
        j, t = jax_tree_to_numpy(js), state_to_numpy(ts)
        assert int(j["asas.nconf_cur"]) > 0
        for f in ("asas.resopairs", "asas.active", "asas.inconf",
                  "asas.nconf_cur", "asas.nlos_cur"):
            np.testing.assert_array_equal(t[f], j[f], err_msg=f"{k} {f}")
        for f in ("asas.trk", "asas.tas", "asas.vs", "asas.alt",
                  "asas.asase", "asas.asasn", "asas.tcpamax"):
            close(t[f], j[f], atol=1e-8, err=f"{k} {f}")
        if k:
            released += int((prev & ~t["asas.resopairs"]).sum())
        prev = t["asas.resopairs"]
        js, ts = _move(js, ts, 20.0)
    assert released > 0
    js, jd = jasas.detect_only(js, jcfg)
    ts, td = tasas.detect_only(ts, tcfg)
    j, t = jax_tree_to_numpy(js), state_to_numpy(ts)
    for f in ("asas.inconf", "asas.nconf_cur", "asas.nlos_cur"):
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    close(t["asas.tcpamax"], j["asas.tcpamax"], atol=1e-9)
    np.testing.assert_array_equal(td.swconfl.numpy(), np.asarray(jd.swconfl))
