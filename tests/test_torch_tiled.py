"""The port's ``tiled`` CD&R backend against the JAX package, in float64,
on numpy-seeded inputs: ``cd_tiled.detect_resolve_tiled`` at block 16
and 32 (ragged padding) with K = 8 and 16, on a fleet where several
aircraft share one position and velocity, so that their entry times tie
and the partner candidates ``topk_idx`` must come in the JAX order (by
entry time, ties to the lower sorted-space column); its Eby and Swarm
forms; then ``refresh_spatial_sort(impl="lax")`` and
``update_tiled(impl="lax")`` over three intervals, with MVP and with
each of the other resolvers.

Tolerances: flags, counts, partner ids (in order) and the Morton sort
equal; the entry times and tcpamax at rtol 1e-10; the MVP and Swarm
sums at rtol 1e-9 / atol 1e-9 (the port sums a row's reachable columns
at once, JAX tile by tile); the commands of the resolver runs at rtol
1e-7 and the Eby sums at rtol 1e-5 (the Eby quadratic cancels on a
near-grazing pair and degenerates on the tied copies, which lifts
float64 rounding to ~1e-9 and ~1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import asas as jasas
from bluesky_tpu.ops import cd_tiled as jtiled, cr_mvp as jmvp
from bluesky_tpu_torch.core import asas as tasas
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.ops import cd_tiled as ttiled, cr_mvp as tmvp

from torch_parity import FT, NM, build_pair, jax_tree_to_numpy

RPZ, HPZ, TLOOK = 5.0 * NM, 1000.0 * FT, 300.0
KW = dict(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05, tlookahead=TLOOK)


def scene(n=77, nmax=100, seed=3):
    """A clump of ``n`` aircraft in ``nmax`` slots, the first 15 %
    inactive, three noreso; aircraft 21-26 are copies of aircraft 20
    (one position and velocity: tied entry times)."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    lat, lon = u(51.8, 52.2), u(3.8, 4.2)
    trk, gs = u(0.0, 360.0), u(150.0, 250.0)
    alt, vs = u(3000.0, 3300.0), u(-3.0, 3.0)
    for a in (lat, lon, trk, gs, alt, vs):
        a[21:27] = a[20]
    pad = lambda a: np.concatenate([a, np.zeros(nmax - n)])
    cols = [pad(a) for a in (lat, lon, trk, gs, alt, vs)]
    trkrad = np.radians(cols[2])
    cols += [cols[3] * np.sin(trkrad), cols[3] * np.cos(trkrad)]
    active = np.zeros(nmax, bool)
    active[int(0.15 * n):n] = True
    noreso = np.zeros(nmax, bool)
    noreso[[40, 41, 60]] = True
    return cols + [active, noreso]


@pytest.mark.parametrize("block,k", [(16, 8), (16, 16), (32, 8), (32, 16)])
def test_detect_resolve_tiled(block, k):
    cols = scene()
    j = jtiled.detect_resolve_tiled(
        *[jnp.asarray(a) for a in cols], RPZ, HPZ, TLOOK,
        jmvp.MVPConfig(**KW), block=block, k_partners=k)
    t = ttiled.detect_resolve_tiled(
        *[torch.from_numpy(a.copy()) for a in cols], RPZ, HPZ, TLOOK,
        tmvp.MVPConfig(**KW), block=block, k_partners=k)
    assert int(j.nconf) > 0 and int(j.nlos) > 0
    for f in ("inconf", "nconf", "nlos", "topk_idx"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("tcpamax", "tsolv", "topk_tin"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-10,
                                   err_msg=f)
    for f in ("sum_dve", "sum_dvn", "sum_dvv"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-9,
                                   atol=1e-9, err_msg=f)
    # the tie case is real: an ownship sees the six copies of aircraft 20
    # with equal entry times among its candidates
    idx, tin = t.topk_idx.numpy(), t.topk_tin.numpy()
    copies = np.isin(idx, np.arange(20, 27))
    assert any((copies[i].sum() >= 2 and len(set(tin[i][copies[i]])) == 1)
               for i in range(len(idx)))
    assert ttiled.LAST_CALL["iterations"] <= ttiled.LAST_CALL["nb"]


@pytest.mark.parametrize("reso", ["eby", "swarm"])
def test_detect_resolve_tiled_resolver_forms(reso):
    """The Eby sums on the exact TAS velocities and the seven Swarm
    neighbour sums (with the swarm-widened reach), at block 16 and K = 8,
    with tas (Eby) and cas (Swarm) columns from a numpy seed."""
    cols = scene()
    rng = np.random.default_rng(8)
    ratio = rng.uniform(0.6, 1.1, cols[3].shape[0])
    key = "tas" if reso == "eby" else "cas"
    extra = cols[3] * ratio
    j = jtiled.detect_resolve_tiled(
        *[jnp.asarray(a) for a in cols], RPZ, HPZ, TLOOK,
        jmvp.MVPConfig(**KW), block=16, k_partners=8, reso=reso,
        extra_cols={key: jnp.asarray(extra)})
    t = ttiled.detect_resolve_tiled(
        *[torch.from_numpy(a.copy()) for a in cols], RPZ, HPZ, TLOOK,
        tmvp.MVPConfig(**KW), block=16, k_partners=8, reso=reso,
        extra_cols={key: torch.from_numpy(extra)})
    if reso == "swarm":
        (j, jsw), (t, tsw) = j, t
        assert float(tsw[0].sum()) > 0
        for a, b in zip(tsw, jsw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-9)
    assert int(j.nconf) > 0
    for f in ("inconf", "nconf", "nlos", "topk_idx"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    # Eby: the copies of aircraft 20 are on an exact collision course
    # (distance 0), where the quadratic degenerates and float64 rounding
    # of the two packages parts at ~1e-6
    rtol = 1e-5 if reso == "eby" else 1e-9
    for f in ("tcpamax", "sum_dve", "sum_dvn", "sum_dvv", "tsolv"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=rtol,
                                   atol=1e-9, err_msg=f)


def test_without_prefilter_or_sort():
    """Every tile visited (``prefilter=False``) in caller slot order
    (``spatial_sort=False``): the same rows as JAX."""
    cols = scene(n=50, nmax=64)
    kw = dict(block=16, k_partners=8, prefilter=False, spatial_sort=False)
    j = jtiled.detect_resolve_tiled(*[jnp.asarray(a) for a in cols], RPZ,
                                    HPZ, TLOOK, jmvp.MVPConfig(**KW), **kw)
    t = ttiled.detect_resolve_tiled(*[torch.from_numpy(a.copy())
                                      for a in cols], RPZ, HPZ, TLOOK,
                                    tmvp.MVPConfig(**KW), **kw)
    assert ttiled.LAST_CALL["tiles"] == 16 and int(j.nconf) > 0
    for f in ("inconf", "nconf", "nlos", "topk_idx"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("tcpamax", "sum_dve", "sum_dvn", "sum_dvv", "tsolv"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-9,
                                   atol=1e-9, err_msg=f)


def test_block_smaller_than_k_raises():
    cols = [torch.from_numpy(a.copy()) for a in scene()]
    with pytest.raises(ValueError, match="k_partners"):
        ttiled.detect_resolve_tiled(*cols, RPZ, HPZ, TLOOK,
                                    tmvp.MVPConfig(**KW), block=8,
                                    k_partners=16)


def test_first_k_matches_a_stable_sort():
    """The k smallest of each row by (value, column), with many ties,
    equal the head of a stable sort."""
    rng = np.random.default_rng(0)
    urg = torch.from_numpy(rng.integers(0, 6, (40, 300)).astype(np.float64))
    urg[3] = 1e9
    vals, cols = ttiled._first_k(urg, 8)
    want_vals, want_cols = torch.sort(urg, dim=1, stable=True)
    assert torch.equal(vals, want_vals[:, :8])
    assert torch.equal(cols, want_cols[:, :8])


def _move(js, ts, dt):
    """Advance both states' positions ``dt`` seconds (flat earth)."""
    lat, lon = np.asarray(js.ac.lat), np.asarray(js.ac.lon)
    gsn, gse = np.asarray(js.ac.gsnorth), np.asarray(js.ac.gseast)
    lat2 = lat + gsn * dt / 111320.0
    lon2 = lon + gse * dt / (111320.0 * np.cos(np.radians(lat)))
    js = js.replace(ac=js.ac.replace(lat=jnp.asarray(lat2),
                                     lon=jnp.asarray(lon2)))
    ts = ts.replace(ac=ts.ac.replace(lat=torch.from_numpy(lat2.copy()),
                                     lon=torch.from_numpy(lon2.copy())))
    return js, ts


def _three_intervals(method):
    """The Morton refresh, then three ``update_tiled(impl="lax")``
    intervals 20 s apart with the resolver ``method``: the caller-space
    partner table (in order), the flags, counts and commands as in
    JAX."""
    js, ts = build_pair(64, 60, geom="clump", seed=3, dtype="float64")
    jcfg = jasas.AsasConfig(reso_method=method)
    tcfg = tasas.AsasConfig(reso_method=method)
    js = jasas.refresh_spatial_sort(js, jcfg, block=16, impl="lax")
    ts = tasas.refresh_spatial_sort(ts, tcfg, block=16, impl="lax")
    np.testing.assert_array_equal(ts.asas.sort_perm.numpy(),
                                  np.asarray(js.asas.sort_perm))
    assert not np.array_equal(ts.asas.sort_perm.numpy(), np.arange(64))
    released = 0
    for k in range(3):
        js, _ = jasas.update_tiled(js, jcfg, block=16, impl="lax")
        ts, _ = tasas.update_tiled(ts, tcfg, block=16, impl="lax")
        j, t = jax_tree_to_numpy(js), state_to_numpy(ts)
        assert int(j["asas.nconf_cur"]) > 0
        for f in ("asas.partners", "asas.active", "asas.inconf",
                  "asas.nconf_cur", "asas.nlos_cur"):
            np.testing.assert_array_equal(t[f], j[f], err_msg=f"{k} {f}")
        for f in ("asas.trk", "asas.tas", "asas.vs", "asas.alt",
                  "asas.asase", "asas.asasn", "asas.tcpamax"):
            np.testing.assert_allclose(
                t[f], j[f], rtol=1e-10 if method == "MVP" else 1e-7,
                atol=1e-8, err_msg=f"{k} {f}")
        if k:
            released += int(((prev >= 0).sum(1)
                             > (t["asas.partners"] >= 0).sum(1)).sum())
        prev = t["asas.partners"]
        js, ts = _move(js, ts, 20.0)
    assert released > 0


def test_update_tiled_lax_three_intervals():
    """The Morton refresh and three intervals with MVP
    (``_three_intervals``)."""
    _three_intervals("MVP")


@pytest.mark.parametrize("method", ["EBY", "SWARM", "SSD"])
def test_update_tiled_lax_resolvers(method):
    """``_three_intervals`` with each of the other resolvers."""
    _three_intervals(method)
