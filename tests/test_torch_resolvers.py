"""The port's Eby, Swarm and SSD resolvers (``ops/cr_eby.py``,
``ops/cr_swarm.py``, ``ops/cr_ssd.py``) and the dense interval that runs
them (``core/asas.update``) against the JAX package, in float64 on
numpy-seeded inputs.

Tolerances: flags, counts, the Swarm neighbour flags and the
ASAS-engaged flags equal; the Swarm sums and commands within rtol 1e-9 /
atol 1e-9 (float64 rounding of the same formulas, summed in another
order).  The SSD picks (an argmin over the candidate grid) are the same
candidates, so their tracks and speeds agree to 1e-9 too.  The Eby
displacement, and every command of the two-interval dense runs, within
rtol 1e-7: on a near-grazing conflict the Eby quadratic's discriminant
cancels to 1e-7 of its terms, which lifts float64 rounding to ~1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import asas as jasas
from bluesky_tpu.ops import cd as jcd, cr_eby as jeby, cr_ssd as jssd, \
    cr_swarm as jswarm
from bluesky_tpu_torch.core import asas as tasas
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.ops import cd as tcd, cr_eby, cr_ssd, cr_swarm

from torch_parity import FT, NM, build_pair, jax_tree_to_numpy

RPZ, HPZ, TLOOK = 5 * NM, 1000 * FT, 300.0
VMIN, VMAX = 51.4, 92.6
TOL = dict(rtol=1e-9, atol=1e-9)


def scene(n=96, seed=4, spread=0.5):
    """Per-aircraft float64 columns of a clump of ``n`` aircraft (about
    100 conflict pairs), the last 6 inactive."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    c = dict(lat=u(52.0, 52.0 + spread), lon=u(4.0, 4.0 + 1.6 * spread),
             trk=u(0.0, 360.0), gs=u(130.0, 240.0), alt=u(3000.0, 3900.0),
             vs=u(-5.0, 5.0), tas=u(140.0, 250.0), cas=u(100.0, 170.0),
             selspd=u(120.0, 160.0), selvs=u(-3.0, 3.0), aptrk=u(0, 360.0),
             hdg=u(0.0, 360.0))
    trk = np.radians(c["trk"])
    c.update(gse=c["gs"] * np.sin(trk), gsn=c["gs"] * np.cos(trk),
             active=np.arange(n) < n - 6,
             mvp_active=rng.random(n) < 0.5)
    return c


def both(c, *keys):
    """The columns ``keys`` of ``c`` as JAX and as torch arrays."""
    return ([jnp.asarray(c[k]) for k in keys],
            [torch.from_numpy(np.asarray(c[k]).copy()) for k in keys])


def detect(c):
    keys = ("lat", "lon", "trk", "gs", "alt", "vs", "active")
    j, t = both(c, *keys)
    return (jcd.detect(*j, RPZ, HPZ, TLOOK), tcd.detect(*t, RPZ, HPZ, TLOOK))


def close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(kw or TOL))


def test_eby_pair_contrib_matches_jax():
    """The per-pair displacement over every pair of the clump, near and
    far, in float64."""
    c = scene()
    jcd_, tcd_ = detect(c)
    dist = np.asarray(jcd_.dist)
    qdr = np.radians(np.asarray(jcd_.qdr))
    trk = np.radians(c["trk"])
    ve, vn = c["tas"] * np.sin(trk), c["tas"] * np.cos(trk)
    args = [dist * np.sin(qdr), dist * np.cos(qdr),
            c["alt"][None, :] - c["alt"][:, None],
            ve[None, :] - ve[:, None], vn[None, :] - vn[:, None],
            c["vs"][None, :] - c["vs"][:, None]]
    j = jeby.pair_contrib(*[jnp.asarray(a) for a in args], RPZ * 1.05)
    t = cr_eby.pair_contrib(*[torch.from_numpy(a) for a in args], RPZ * 1.05)
    conf = np.asarray(jcd_.swconfl)
    assert conf.sum() > 50
    for a, b in zip(t, j):
        close(a.numpy()[conf], np.asarray(b)[conf], rtol=1e-7, atol=1e-9)
        assert np.isfinite(a.numpy()).all()


def test_eby_resolve_matches_jax(monkeypatch):
    """``cr_eby.resolve`` on the dense matrices and
    ``resolve_from_sums`` on seeded sums."""
    c = scene()
    jcd_, tcd_ = detect(c)
    jk, tk = both(c, "alt", "vs", "trk", "tas")
    j = jeby.resolve(jcd_, *jk, RPZ * 1.05, VMIN, VMAX)
    t = cr_eby.resolve(tcd_, *tk, RPZ * 1.05, VMIN, VMAX)
    for a, b in zip(t, j):
        close(a, b, rtol=1e-7, atol=1e-7)
    # row chunks of the pair evaluation change no bit
    monkeypatch.setattr(cr_eby, "ROWS", 16)
    for a, b in zip(cr_eby.resolve(tcd_, *tk, RPZ * 1.05, VMIN, VMAX), t):
        assert torch.equal(a, b)
    rng = np.random.default_rng(1)
    sums = [rng.normal(0, 30, len(c["alt"])) for _ in range(3)]
    j = jeby.resolve_from_sums(*map(jnp.asarray, sums), *jk, VMIN, VMAX)
    t = cr_eby.resolve_from_sums(*map(torch.from_numpy, sums), *tk, VMIN,
                                 VMAX)
    for a, b in zip(t, j):
        close(a, b)


def test_swarm_track_wrap_near_180():
    """The floored modulo of the track difference, with differences near
    -180, +180, -90 and +90 deg and exact multiples of 360."""
    rng = np.random.default_rng(0)
    base = np.array([-540.0, -360.0, -180.0, -90.0, 0.0, 90.0, 180.0, 360.0])
    x = np.concatenate([base, (base[:, None] + rng.uniform(
        -1e-3, 1e-3, (8, 16))).ravel()])
    for dtype in (np.float32, np.float64):
        xs = x.astype(dtype)
        j = np.asarray((jnp.asarray(xs) + 180.0) % 360.0 - 180.0)
        t = cr_swarm.wrap_track(torch.from_numpy(xs)).numpy()
        np.testing.assert_array_equal(t, j)
        assert ((t >= -180.0) & (t < 180.0)).all()
    # torch.fmod truncates: it would give +180 - 360 wrongly signed values
    assert (torch.fmod(torch.tensor([-190.0]) + 180.0, 360.0)
            - 180.0).item() == -190.0


def test_swarm_pair_weight_and_resolve_match_jax():
    c = scene()
    jcd_, tcd_ = detect(c)
    keys = ("lat", "lon", "alt", "trk", "gs", "cas", "vs", "gse", "gsn",
            "active")
    jk, tk = both(c, *keys)
    mvp = ("trk", "tas", "vs", "mvp_active", "aptrk", "selspd", "selvs")
    jm, tm = both(c, *mvp)
    j = jswarm.resolve(jcd_, *jk, *jm, VMIN, VMAX)
    t = cr_swarm.resolve(tcd_, *tk, *tm, VMIN, VMAX)
    for a, b in zip(t, j):
        close(a, b)
    # the neighbour flags and the seven sums of the blockwise backends
    dist = np.asarray(jcd_.dist)
    qdr = np.radians(np.asarray(jcd_.qdr))
    dx, dy = dist * np.sin(qdr), dist * np.cos(qdr)
    dalt = c["alt"][None, :] - c["alt"][:, None]
    dtrk = (c["trk"][None, :] - c["trk"][:, None] + 180.0) % 360.0 - 180.0
    act = c["active"]
    ok = act[:, None] & act[None, :] & ~np.eye(len(act), dtype=bool)
    wj = np.asarray(jswarm.pair_weight(*map(jnp.asarray,
                                            (dx, dy, dalt, dtrk, ok))))
    wt = cr_swarm.pair_weight(*map(torch.from_numpy,
                                   (dx, dy, dalt, dtrk, ok))).numpy()
    np.testing.assert_array_equal(wt, wj)
    assert 0 < wt.sum() < ok.sum()
    w = wt.astype(float)
    sums = [w.sum(1)] + [(w * v).sum(1) for v in (
        c["cas"][None, :], c["vs"][None, :], dtrk, dx, dy, c["alt"][None, :])]
    tail = ("alt", "trk", "cas", "vs", "gse", "gsn", "active")
    jt, tt = both(c, *tail)
    j = jswarm.resolve_from_sums(*map(jnp.asarray, sums), *jt, *jm, VMIN,
                                 VMAX)
    t = cr_swarm.resolve_from_sums(*map(torch.from_numpy, sums), *tt, *tm,
                                   VMIN, VMAX)
    for a, b in zip(t, j):
        close(a, b)


RULES = ["RS1", "RS2", "RS3", "RS4", "RS5", "RS6", "RS7", "RS8", "RS9"]


def _ssd_cfg(mod, rule, chunk=32):
    return mod.SSDConfig(rpz_m=RPZ * 1.05, tlookahead=TLOOK, priocode=rule,
                         chunk=chunk)


@pytest.mark.parametrize("rule", RULES)
def test_ssd_resolve_matches_jax(rule):
    """The dense SSD (intruder axis in chunks of 32) per priority rule."""
    c = scene(seed=7, spread=0.8)
    jcd_, tcd_ = detect(c)
    keys = ("lat", "lon", "alt", "trk", "gs", "vs", "gse", "gsn", "active")
    jk, tk = both(c, *keys)
    jx, tx = both(c, "hdg", "aptrk", "tas")
    j = jssd.resolve(jcd_, *jk, VMIN, VMAX, _ssd_cfg(jssd, rule),
                     hdg=jx[0], ap_trk=jx[1], ap_tas=jx[2])
    t = cr_ssd.resolve(tcd_, *tk, VMIN, VMAX, _ssd_cfg(cr_ssd, rule),
                       hdg=tx[0], ap_trk=tx[1], ap_tas=tx[2])
    inconf = np.asarray(jcd_.inconf)
    assert inconf.sum() > 10
    for a, b in zip(t, j):
        close(a, b)
    # the resolution really moved the in-conflict aircraft
    assert (np.abs(t[0].numpy() - c["trk"])[inconf] > 1e-6).any() \
        or (np.abs(t[1].numpy() - c["gs"])[inconf] > 1e-6).any()


def test_ssd_slab_bound_changes_nothing(monkeypatch):
    """Slabs narrowed to 3 intruders by the element bound (it keeps the
    dense [N, C, chunk] temporaries at 512 MB) give the same picks."""
    c = scene(seed=7, spread=0.8)
    _, tcd_ = detect(c)
    keys = ("lat", "lon", "alt", "trk", "gs", "vs", "gse", "gsn", "active")
    tk = both(c, *keys)[1]
    want = cr_ssd.resolve(tcd_, *tk, VMIN, VMAX, _ssd_cfg(cr_ssd, "RS7"))
    monkeypatch.setattr(cr_ssd, "_SLAB_ELEMENTS", 3 * 96 * 146)
    got = cr_ssd.resolve(tcd_, *tk, VMIN, VMAX, _ssd_cfg(cr_ssd, "RS7"))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rule", RULES)
def test_ssd_resolve_from_partners_matches_jax(rule):
    """SSD from an [N, 8] caller-space partner table (the first 8
    conflict intruders of each row, -1 empty), candidate axis in chunks
    of 16."""
    c = scene(seed=7, spread=0.8)
    jcd_, _ = detect(c)
    conf = np.asarray(jcd_.swconfl)
    n = conf.shape[0]
    table = np.full((n, 8), -1, np.int32)
    for i in range(n):
        ids = np.flatnonzero(conf[i])[:8]
        table[i, :len(ids)] = ids
    assert (table >= 0).sum() > 50
    inconf = np.array(jcd_.inconf)
    keys = ("lat", "lon", "alt", "trk", "gs", "vs", "gse", "gsn", "active")
    jk, tk = both(c, *keys)
    jx, tx = both(c, "hdg", "aptrk", "tas")
    j = jssd.resolve_from_partners(
        jnp.asarray(table), jnp.asarray(inconf), *jk, VMIN, VMAX,
        _ssd_cfg(jssd, rule), hdg=jx[0], ap_trk=jx[1], ap_tas=jx[2])
    t = cr_ssd.resolve_from_partners(
        torch.from_numpy(table), torch.from_numpy(inconf), *tk, VMIN, VMAX,
        _ssd_cfg(cr_ssd, rule), hdg=tx[0], ap_trk=tx[1], ap_tas=tx[2])
    for a, b in zip(t, j):
        close(a, b)


@pytest.mark.parametrize("method", ["EBY", "SWARM", "SSD"])
def test_dense_update_matches_jax(method):
    """``asas.update`` (the dense interval) with each resolver, two
    intervals 20 s apart, in float64: the commands, flags and the pair
    matrix; under SWARM every active aircraft is engaged once a conflict
    exists."""
    js, ts = build_pair(128, 110, geom="clump", seed=5, dtype="float64",
                        pair_matrix=True)
    jcfg = jasas.AsasConfig(reso_method=method)
    tcfg = tasas.AsasConfig(reso_method=method)
    for k in range(2):
        js, _ = jasas.update(js, jcfg)
        ts, _ = tasas.update(ts, tcfg)
        j, t = jax_tree_to_numpy(js), state_to_numpy(ts)
        assert int(j["asas.nconf_cur"]) > 0
        for f in ("asas.resopairs", "asas.active", "asas.inconf",
                  "asas.nconf_cur", "asas.nlos_cur"):
            np.testing.assert_array_equal(t[f], j[f], err_msg=f"{k} {f}")
        for f in ("asas.trk", "asas.tas", "asas.vs", "asas.alt",
                  "asas.asase", "asas.asasn", "asas.tcpamax"):
            np.testing.assert_allclose(t[f], j[f], rtol=1e-7, atol=1e-7,
                                       err_msg=f"{k} {f}")
        if method == "SWARM":
            assert (t["asas.active"] == t["ac.active"]).all()
        lat, lon = np.asarray(js.ac.lat), np.asarray(js.ac.lon)
        gsn, gse = np.asarray(js.ac.gsnorth), np.asarray(js.ac.gseast)
        lat2 = lat + gsn * 20.0 / 111320.0
        lon2 = lon + gse * 20.0 / (111320.0 * np.cos(np.radians(lat)))
        js = js.replace(ac=js.ac.replace(lat=jnp.asarray(lat2),
                                         lon=jnp.asarray(lon2)))
        ts = ts.replace(ac=ts.ac.replace(lat=torch.from_numpy(lat2.copy()),
                                         lon=torch.from_numpy(lon2.copy())))


def test_unknown_resolver_raises():
    ts = build_pair(8, 4)[1]
    with pytest.raises(ValueError, match="reso_method"):
        tasas.update_tiled(ts, tasas.AsasConfig(reso_method="FOO"))
    # RESO OFF does not read the method
    tasas.require_resolver(tasas.AsasConfig(reso_method="FOO", reso_on=False))


def test_eby_finite_at_airspace_scale():
    """Dense EBY in float32 on 300 aircraft spread over 20 x 40 deg (pairs
    thousands of km apart, and the 1e9 offsets of the masked pairs):
    every command finite in both packages, as the JAX package's
    ``test_eby_no_nan_at_airspace_scale`` asks of it; the in-conflict
    flags equal."""
    from bluesky_tpu.core.traffic import Traffic as JTraffic
    from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
    rng = np.random.default_rng(3)
    n = 300
    args = (rng.uniform(3000, 11000, n), rng.uniform(130, 240, n), None,
            rng.uniform(40.0, 60.0, n), rng.uniform(-10.0, 30.0, n),
            rng.uniform(0, 360, n))
    jt = JTraffic(nmax=n, dtype=jnp.float32)
    tt = TTraffic(nmax=n, dtype=torch.float32, device="cpu")
    for tr in (jt, tt):
        tr.create(n, "B744", *args)
        tr.flush()
    js, _ = jasas.update(jt.state, jasas.AsasConfig(reso_method="EBY"))
    ts, _ = tasas.update(tt.state, tasas.AsasConfig(reso_method="EBY"))
    j, t = jax_tree_to_numpy(js), state_to_numpy(ts)
    assert int(t["asas.nconf_cur"]) == int(j["asas.nconf_cur"]) > 0
    np.testing.assert_array_equal(t["asas.inconf"], j["asas.inconf"])
    for f in ("asas.trk", "asas.tas", "asas.vs", "asas.alt"):
        assert np.isfinite(t[f]).all() and np.isfinite(j[f]).all(), f
