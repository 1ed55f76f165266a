"""The port's sparse CD&R module (``ops/cd_sched.detect_resolve_sched``,
plain PyTorch versions of both kernels on the CPU) against the JAX
``cd_sched.detect_resolve_sched`` with its Pallas kernels in interpret
mode, in float32, with the partner table (in-kernel resume-nav).

Each geometry runs two intervals: a fresh one from an empty partner
table, then a resumed one from the JAX pass's merged table with the
fleet moved 20 s along its tracks, so the keep predicate decides real
old partners.  Flags, counts, the ASAS-engaged flags and the partner
sets are equal; the float reductions within rtol 1e-4 / atol 5e-3, the
f32 summation-order bound of tests/test_cd_sched.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.ops import cd_sched as jsched, cr_mvp as jmvp
from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cr_mvp

from torch_parity import FT, NM, partner_sets, slab64

N = 300
BLOCK = 64
RPZ, HPZ, TLOOK = 5 * NM, 1000 * FT, 300.0


def columns(geom, seed=0):
    rng = np.random.default_rng(seed)
    if geom == "clump":
        ang = rng.uniform(0, 2 * np.pi, N)
        r = 1.5 * np.sqrt(rng.random(N))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    elif geom == "equator":
        lat = rng.uniform(-3.0, 3.0, N)
        lon = rng.uniform(-4.0, 4.0, N)
    else:
        lat = rng.uniform(45.0, 58.0, N)
        lon = rng.uniform(-5.0, 15.0, N)
    gs = rng.uniform(130.0, 240.0, N)
    trk = rng.uniform(0.0, 360.0, N)
    alt = rng.uniform(8000.0, 11000.0, N)
    vs = rng.uniform(-8.0, 8.0, N)
    active = rng.random(N) > 0.05
    noreso = rng.random(N) > 0.9
    return dict(lat=lat, lon=lon, trk=trk, gs=gs, alt=alt, vs=vs,
                active=active, noreso=noreso)


def moved(c, t):
    trk = np.radians(c["trk"])
    d = dict(c)
    d["lat"] = c["lat"] + c["gs"] * np.cos(trk) * t / 111320.0
    d["lon"] = c["lon"] + c["gs"] * np.sin(trk) * t / (
        111320.0 * np.cos(np.radians(d["lat"])))
    return d


def ordered(c):
    """The detect_resolve_sched argument columns, as numpy float32/bool."""
    trk = np.radians(c["trk"])
    f = lambda a: np.asarray(a, np.float32)
    return [f(c["lat"]), f(c["lon"]), f(c["trk"]), f(c["gs"]), f(c["alt"]),
            f(c["vs"]), f(c["gs"] * np.sin(trk)), f(c["gs"] * np.cos(trk)),
            np.asarray(c["active"]), np.asarray(c["noreso"])]


@functools.lru_cache(maxsize=None)
def _jax_fn(s_cap):
    cfg = jmvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                         tlookahead=TLOOK)

    @jax.jit
    def run(cols, perm, partners):
        return jsched.detect_resolve_sched(
            *cols, RPZ, HPZ, TLOOK, cfg, block=BLOCK, s_cap=s_cap,
            interpret=True, perm=perm, partners=partners,
            resume_rpz_m=RPZ * 1.05)
    return run


def run_jax(cols, perm, partners, s_cap):
    rd, pnew, act = _jax_fn(s_cap)([jnp.asarray(a) for a in cols],
                                   jnp.asarray(perm), jnp.asarray(partners))
    return jax.tree_util.tree_map(np.asarray, (rd, pnew, act))


def run_torch(cols, perm, partners, s_cap):
    cfg = cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                           tlookahead=TLOOK)
    rd, pnew, act = cd_sched.detect_resolve_sched(
        *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, cfg,
        partners=torch.from_numpy(np.array(partners)),
        resume_rpz_m=RPZ * 1.05,
        block=BLOCK, s_cap=s_cap, perm=torch.from_numpy(perm))
    return [np.asarray(x) for x in rd], pnew.numpy(), act.numpy()


def assert_match(j, t):
    (jrd, jp, ja), (trd, tp, ta) = j, t
    fields = jrd._fields
    jd, td = dict(zip(fields, jrd)), dict(zip(fields, trd))
    for k in ("inconf", "nconf", "nlos"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for k in ("tcpamax", "sum_dve", "sum_dvn", "sum_dvv", "tsolv"):
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=5e-3,
                                   err_msg=k)
    assert partner_sets(td["topk_idx"]) == partner_sets(jd["topk_idx"])
    assert partner_sets(tp) == partner_sets(jp)
    np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("geom,s_cap", [("spread", 6), ("clump", 1),
                                        ("equator", 6)])
def test_sched_matches_jax(geom, s_cap):
    c = columns(geom)
    cols = ordered(c)
    lat, lon, _, gs, *_ = cols
    act = torch.from_numpy(cols[8])
    gs_t = torch.from_numpy(gs)
    thresh = cd_sched.reach_threshold_m(gs_t, act, TLOOK, RPZ)
    perm = cd_sched.stripe_sort_dest(
        torch.from_numpy(lat), torch.from_numpy(lon), gs_t, act, thresh,
        BLOCK, 32).numpy()
    n_tot = cd_sched.padded_size(N, BLOCK)
    table = np.full((n_tot, 8), -1, np.int32)
    x = cd_sched.prepare(*[torch.from_numpy(a) for a in cols], RPZ, HPZ,
                         TLOOK, torch.from_numpy(table), block=BLOCK,
                         s_cap=s_cap, perm=torch.from_numpy(perm))
    if geom == "clump":
        assert int(x.overflow.sum()) > 0      # the fallback pass has rows
    j = run_jax(cols, perm, table, s_cap)
    assert int(j[0].nconf) > 0
    assert_match(j, run_torch(cols, perm, table, s_cap))

    # resumed interval: old partners from the JAX pass, fleet moved on
    cols2 = ordered(moved(c, 20.0))
    j2 = run_jax(cols2, perm, j[1], s_cap)
    assert (j2[1] >= 0).sum() > 0
    assert_match(j2, run_torch(cols2, perm, j[1], s_cap))


@functools.lru_cache(maxsize=None)
def _jax_fn_reso(reso):
    cfg = jmvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                         tlookahead=TLOOK)

    @jax.jit
    def run(cols, perm, partners, extra):
        return jsched.detect_resolve_sched(
            *cols, RPZ, HPZ, TLOOK, cfg, block=BLOCK, s_cap=1,
            interpret=True, perm=perm, partners=partners,
            resume_rpz_m=RPZ * 1.05, reso=reso,
            tas=extra if reso == "eby" else None,
            cas=extra if reso == "swarm" else None)
    return run


@pytest.mark.parametrize("reso", ["eby", "swarm"])
def test_sched_resolver_forms_match_jax(reso):
    """The Eby and Swarm forms of ``detect_resolve_sched`` on the clump
    (``s_cap=1``: overflow rows, so both kernels run), a fresh and a
    resumed interval, against JAX in interpret mode: flags, counts, the
    engaged flags and the partner sets equal; the MVP-side floats and the
    Swarm sums within rtol 1e-4 / atol 5e-3; the Eby sums within that of
    the float64 witness, and JAX's within it of the port's wherever
    JAX's lies within it of the witness (``test_torch_cd_pallas``)."""
    c = columns("clump")
    rng = np.random.default_rng(12)
    lo, hi = (0.9, 1.1) if reso == "eby" else (0.6, 0.8)
    extra = (c["gs"] * rng.uniform(lo, hi, N)).astype(np.float32)
    key = "tas" if reso == "eby" else "cas"
    cfg = cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                           tlookahead=TLOOK)
    cols = ordered(c)
    act = torch.from_numpy(cols[8])
    gs_t = torch.from_numpy(cols[3])
    perm = cd_sched.stripe_sort_dest(
        torch.from_numpy(cols[0]), torch.from_numpy(cols[1]), gs_t, act,
        cd_sched.reach_threshold_m(gs_t, act, TLOOK, RPZ), BLOCK, 32).numpy()
    table = np.full((cd_sched.padded_size(N, BLOCK), 8), -1, np.int32)
    close = lambda a, b: np.isclose(a, b, rtol=1e-4, atol=5e-3)
    for k in range(2):
        cols = ordered(moved(c, 20.0 * k))
        out_j = jax.tree_util.tree_map(np.asarray, _jax_fn_reso(reso)(
            [jnp.asarray(a) for a in cols], jnp.asarray(perm),
            jnp.asarray(table), jnp.asarray(extra)))
        out_t = cd_sched.detect_resolve_sched(
            *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, cfg,
            partners=torch.from_numpy(np.array(table)),
            resume_rpz_m=RPZ * 1.05, block=BLOCK, s_cap=1,
            perm=torch.from_numpy(perm),
            tas=torch.from_numpy(extra) if reso == "eby" else None,
            cas=torch.from_numpy(extra) if reso == "swarm" else None,
            reso=reso)
        (jrd, jp, ja), (trd, tp, ta) = out_j[:3], out_t[:3]
        assert int(jrd.nconf) > 0
        for f in ("inconf", "nconf", "nlos"):
            np.testing.assert_array_equal(getattr(trd, f).numpy(),
                                          getattr(jrd, f), err_msg=f)
        np.testing.assert_array_equal(ta.numpy(), ja)
        assert partner_sets(trd.topk_idx.numpy()) == partner_sets(
            jrd.topk_idx)
        assert partner_sets(tp.numpy()) == partner_sets(jp)
        sums = ("sum_dve", "sum_dvn", "sum_dvv")
        for f in ("tcpamax", "tsolv") + (sums if reso == "swarm" else ()):
            np.testing.assert_allclose(getattr(trd, f).numpy(),
                                       getattr(jrd, f), rtol=1e-4,
                                       atol=5e-3, err_msg=f)
        if reso == "swarm":
            assert float(out_t[3][0].sum()) > 0
            for name, a, b in zip(cd_pallas.SWARM_SUMS, out_t[3], out_j[3]):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=5e-3, err_msg=name)
        else:
            s = slab64(cols, key, extra)
            w = cd_pallas.row_block_plain(
                s, s, torch.arange(N), torch.arange(N), None,
                cd_pallas.tile_params(RPZ, HPZ, TLOOK, cfg), "eby")
            for f, idx in zip(sums, (2, 3, 4)):
                got, want = getattr(trd, f).numpy(), getattr(jrd, f)
                wit = w[idx].numpy()
                np.testing.assert_allclose(got, wit, rtol=1e-4, atol=5e-3,
                                           err_msg=f"{f} against float64")
                assert (close(got, want) | ~close(want, wit)).all(), f
        table = jp


@pytest.mark.parametrize("geom", ["spread", "clump", "equator"])
def test_schedule_pieces_match_jax(geom):
    """The host side of the schedule is exact: reach radius, stripe
    destinations, padded scatter, slot inverse, reachability and the
    segment windows with their overflow rows."""
    cols = ordered(columns(geom, seed=4))
    lat, lon, _, gs, alt, vs, *_ = cols
    act = cols[8]
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.from_numpy(np.asarray(a).copy())
    th_j = jsched.reach_threshold_m(J(gs), J(act), TLOOK, RPZ)
    th_t = cd_sched.reach_threshold_m(T(gs), T(act), TLOOK, RPZ)
    assert float(th_t) == float(th_j)
    dj = np.asarray(jsched.stripe_sort_dest(J(lat), J(lon), J(gs), J(act),
                                            th_j, BLOCK, 32))
    dt = cd_sched.stripe_sort_dest(T(lat), T(lon), T(gs), T(act), th_t,
                                   BLOCK, 32)
    np.testing.assert_array_equal(dt.numpy(), dj)
    n_tot = cd_sched.padded_size(N, BLOCK)
    assert n_tot == jsched.padded_size(N, BLOCK)
    np.testing.assert_array_equal(
        cd_sched.slot_inverse(dt, N, n_tot).numpy(),
        np.asarray(jsched.slot_inverse(J(dj), N, n_tot)))
    pj = [np.asarray(a) for a in jsched.scatter_padded(
        [J(lat), J(alt), J(act)], J(dj), n_tot)]
    pt = cd_sched.scatter_padded([T(lat), T(alt), T(act)], dt, n_tot)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), b)
    nb = n_tot // BLOCK
    from bluesky_tpu.ops import cd_tiled as jtiled
    from bluesky_tpu_torch.ops import cd_tiled
    pad = lambda a: jsched.scatter_padded([J(a)], J(dj), n_tot)[0]
    reach_j = jtiled.block_reachability(
        pad(lat), pad(lon), pad(gs), pad(act), nb, BLOCK, RPZ, TLOOK,
        alt=pad(alt), vs=pad(vs), hpz=HPZ)
    padt = lambda a: cd_sched.scatter_padded([T(a)], dt, n_tot)[0]
    reach_t = cd_tiled.block_reachability(
        padt(lat), padt(lon), padt(gs), padt(act), nb, BLOCK, RPZ, TLOOK,
        alt=padt(alt), vs=padt(vs), hpz=HPZ)
    np.testing.assert_array_equal(reach_t.numpy(), np.asarray(reach_j))
    for s_cap, wmax in ((6, 16), (1, 16), (2, 2)):
        wj = jsched.build_windows(reach_j, s_cap, wmax, pad_start=nb)
        wt = cd_sched.build_windows(reach_t, s_cap, wmax, pad_start=nb)
        for a, b in zip(wt, wj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors each wrapper returns its plain version's result
    and counts no launch."""
    cols = [torch.from_numpy(a) for a in ordered(columns("clump"))]
    n_tot = cd_sched.padded_size(N, BLOCK)
    x = cd_sched.prepare(*cols, RPZ, HPZ, TLOOK,
                         torch.full((n_tot, 8), -1, dtype=torch.int32),
                         block=BLOCK, s_cap=1)
    cfg = cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                           tlookahead=TLOOK)
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, cfg, RPZ * 1.05)
    reach_f = x.reach & x.overflow[:, None]
    before = (dict(cd_sched.LAUNCHES), dict(cd_pallas.LAUNCHES))
    for got, want in (
            (cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p),
             cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                        x.pold, p)),
            (cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p),
             cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold,
                                              p))):
        assert len(got) == 13
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (dict(cd_sched.LAUNCHES), dict(cd_pallas.LAUNCHES)) == before


def test_compare_outputs_checks_every_output():
    """The kernel-vs-plain check of the card (``compare_outputs``) passes
    equal outputs and names a changed candidate id, merged partner,
    count or float sum."""
    cols = [torch.from_numpy(a) for a in ordered(columns("clump"))]
    n_tot = cd_sched.padded_size(N, BLOCK)
    x = cd_sched.prepare(*cols, RPZ, HPZ, TLOOK,
                         torch.full((n_tot, 8), -1, dtype=torch.int32),
                         block=BLOCK, s_cap=1)
    cfg = cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                           tlookahead=TLOOK)
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, cfg, RPZ * 1.05)
    want = cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                      x.pold, p)
    assert cd_pallas.compare_outputs("same", want, want) == 0.0
    valid = torch.nonzero(want[8] < cd_pallas._BIG)[0].tolist()
    merged = torch.nonzero(want[11] >= 0)[0].tolist()
    for j, at, what in ((9, valid, "candidate sets"),
                        (11, merged, "merged partner sets"),
                        (6, None, "ncnt"), (2, None, "sdve")):
        got = [t.clone() for t in want]
        if at is None:
            got[j] += 1
        else:
            got[j][tuple(at)] = n_tot + 7
        with pytest.raises(AssertionError, match=what):
            cd_pallas.compare_outputs("changed", got, want)
