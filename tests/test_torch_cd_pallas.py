"""The port's pallas CD&R backend (``ops/cd_pallas.py`` with the plain
PyTorch versions of ``_kernel`` and ``_kernel_cand`` on the CPU) and its
host-side pieces against the JAX package, which runs its Pallas kernels
in interpret mode.

Tolerances: the Morton permutation, the candidate tables, the overflow
rows, the partner-table helpers and every bool and integer field of a
``RowConflictData`` (inconf, nconf, nlos, ``topk_idx``) are equal; the
float reductions within rtol 2e-4 / atol 2e-3, the JAX package's own
tolerance for this kernel; the resume displacement in float64 within
rtol 1e-12.

A float that misses that tolerance needs a second witness: the
ownship's row recomputed in float64 from the same float32 inputs.  The
port must lie within the tolerance of it and nearer to it than JAX.  On
the regional geometry one ownship's north MVP sum comes from a single
pair whose ``dcpa_n = drel_n + vrel_n * tcpa`` cancels 75155 m against
75142 m; compiled XLA rounds that pair otherwise (a contracted
multiply-add, two divisions merged into one) and lands 4.5e-3 from the
port.  The test asserts that this is the only such row.

The Eby sums have a witness of their own.  On a near-grazing conflict
the Eby quadratic's ``b*b`` and ``4ac`` agree to 1e-6, and float32
arithmetic moves the pair's displacement by up to tens of percent; the
port computes each Eby pair in float64 (``cr_eby.pair_contrib``), JAX in
float32.  So every Eby sum of the port lies within the tolerance of the
float64 witness, and JAX's within the tolerance of the port's wherever
JAX's itself does of the witness.  That the port computes JAX's Eby
function is shown in float64 as well (``test_tile_body_float64``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import asas as jasas
from bluesky_tpu.ops import cd_pallas as jpallas, cd_tiled as jtiled, \
    cr_mvp as jmvp
from bluesky_tpu_torch.ops import cd_pallas, cd_tiled, cr_mvp

from torch_parity import FT, NM, slab64

RPZ, HPZ, TLOOK = 5 * NM, 1000 * FT, 300.0
N, BLOCK = 512, 64


def columns(n, geom, seed=1):
    """Per-aircraft CD inputs of one geometry, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if geom == "clusters":          # tests/test_cd_pallas_candidates._scene
        centers = [(45 + 5 * (i // 4), -5 + 5 * (i % 4)) for i in range(8)]
        ci = rng.integers(0, 8, n)
        lat = np.array([centers[c][0] for c in ci]) + rng.normal(0, 0.3, n)
        lon = np.array([centers[c][1] for c in ci]) + rng.normal(0, 0.4, n)
    elif geom == "regional":
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 1.5 * np.sqrt(rng.random(n))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    else:               # continental: the JAX candidate tests' uniform
        lat = rng.uniform(40.0, 55.0, n)
        lon = rng.uniform(-5.0, 15.0, n)
    trk = rng.uniform(0.0, 360.0, n)
    gs = rng.uniform(150.0, 250.0, n)
    alt = rng.uniform(3000.0, 11000.0, n)
    vs = rng.uniform(-10.0, 10.0, n)
    f = lambda a: np.asarray(a, np.float32)
    trkr = np.radians(f(trk))
    return [f(lat), f(lon), f(trk), f(gs), f(alt), f(vs),
            f(f(gs) * np.sin(trkr)), f(f(gs) * np.cos(trkr)),
            rng.random(n) > 0.05, rng.random(n) > 0.9]


def _mvp(mod):
    return mod.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                         tlookahead=TLOOK)


@functools.lru_cache(maxsize=None)
def _jax_detect(cand_cap):
    @jax.jit
    def run(cols):
        return jpallas.detect_resolve_pallas(
            *cols, RPZ, HPZ, TLOOK, _mvp(jmvp), block=BLOCK,
            interpret=True, cand_cap=cand_cap)
    return run


def _sorted_inputs(cols):
    """The port's prepared sorted-space operands of ``cols``."""
    t = [torch.from_numpy(a) for a in cols]
    perm = cd_tiled.spatial_permutation(t[0], t[1], t[8])
    return cd_pallas.prepare(*[a[perm] for a in t], RPZ, TLOOK, block=BLOCK)


#: The float fields of a ``RowConflictData`` and their output index in
#: ``row_block_plain``.
_FLOATS = {"tcpamax": 1, "sum_dve": 2, "sum_dvn": 3, "sum_dvv": 4,
           "tsolv": 5, "topk_tin": 8}


def row_float64(cols, i):
    """The float outputs of ownship ``i`` against every aircraft of
    ``cols``, computed in float64 from the same float32 inputs (the slab
    fields of ``cd_pallas.prepare``)."""
    lat, lon, trk, gs, alt, vs, gse, gsn, act, noreso = (
        torch.from_numpy(a).double() for a in cols)
    trkrad = torch.deg2rad(trk)
    f = cd_tiled.precompute_trig(lat, lon)
    f.update(u=gs * torch.sin(trkrad), v=gs * torch.cos(trkrad), alt=alt,
             vs=vs, gse=gse, gsn=gsn, trk=trk, tr=torch.ones_like(gs),
             active=act, noreso=noreso)
    slab = torch.stack([f[k] for k in cd_pallas._FIELDS])
    n = slab.shape[1]
    outs = cd_pallas.row_block_plain(
        slab[:, [i]], slab, torch.tensor([i]), torch.arange(n), None,
        cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(cr_mvp)))
    return {k: outs[j][..., 0].numpy() for k, j in _FLOATS.items()}


def assert_rd_match(t, j, cols):
    """Returns the rows whose floats needed the float64 witness."""
    td, jd = t._asdict(), j._asdict()
    for k in ("inconf", "nconf", "nlos", "topk_idx"):
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]),
                                      err_msg=k)
    witnessed = set()
    for k in _FLOATS:
        got, want = np.asarray(td[k]), np.asarray(jd[k])
        miss = ~np.isclose(got, want, rtol=2e-4, atol=2e-3)
        for idx in map(tuple, np.argwhere(miss)):
            exact = row_float64(cols, idx[0])[k][idx[1:]]
            np.testing.assert_allclose(got[idx], exact, rtol=2e-4,
                                       atol=2e-3, err_msg=f"{k}{idx}")
            assert abs(got[idx] - exact) < abs(want[idx] - exact), (k, idx)
            witnessed.add(idx[0])
    return witnessed


@pytest.mark.parametrize("geom,cand_cap", [
    ("continental", 0), ("regional", 0),
    ("clusters", 448),           # most rows fit their table
    ("clusters", 320)])          # half the rows overflow to the full grid
def test_detect_resolve_pallas_matches_jax(geom, cand_cap):
    cols = columns(N, geom)
    j = _jax_detect(cand_cap)([jnp.asarray(a) for a in cols])
    t = cd_pallas.detect_resolve_pallas(
        *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, _mvp(cr_mvp),
        block=BLOCK, cand_cap=cand_cap)
    assert int(j.nconf) > 0
    # the one ill-conditioned pair of the module docstring
    assert assert_rd_match(t, j, cols) == ({351} if geom == "regional"
                                           else set())
    if cand_cap:
        # both branches of the mixed mode ran: candidate rows and
        # overflow rows
        x = _sorted_inputs(cols)
        assert x.nb >= 8
        _, row_over = cd_pallas.build_candidates(
            x.lat, x.lon, x.gs, x.active, x.nb, x.block, cand_cap, RPZ,
            TLOOK)
        n_over = int(row_over.sum())
        assert 0 < n_over < x.nb
        if cand_cap == 448:
            assert n_over <= x.nb // 4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spatial_permutation_matches_jax(dtype):
    """Equal to the jitted JAX permutation the pallas refresh uses,
    inactive slots and colliding quantized codes included."""
    rng = np.random.default_rng(7)
    n = 4096
    lat = rng.uniform(-90, 90, n)
    lon = rng.uniform(-180, 180, n)
    lat[:64] = 52.0 + rng.uniform(0, 1e-4, 64)        # one shared code
    lon[:64] = 4.0
    lat[64:70], lon[64:70] = -95.0, 190.0             # clipped
    lat, lon = lat.astype(dtype), lon.astype(dtype)
    act = rng.random(n) > 0.2
    j = np.asarray(jasas._morton_perm_jit(jnp.asarray(lat), jnp.asarray(lon),
                                          jnp.asarray(act)))
    t = cd_tiled.spatial_permutation(torch.from_numpy(lat),
                                     torch.from_numpy(lon),
                                     torch.from_numpy(act))
    np.testing.assert_array_equal(t.numpy(), j)


def test_resume_displacement_matches_jax():
    rng = np.random.default_rng(3)
    a = [rng.uniform(-60, 60, 1000), rng.uniform(-180, 180, 1000),
         rng.uniform(-60, 60, 1000), rng.uniform(-180, 180, 1000)]
    j = jmvp.resume_displacement(*[jnp.asarray(x) for x in a])
    t = cr_mvp.resume_displacement(*[torch.from_numpy(x) for x in a])
    for x, y in zip(t, j):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12)


def _tables(n=300, k=8, seed=5):
    rng = np.random.default_rng(seed)
    old = np.where(rng.random((n, k)) < 0.4,
                   rng.integers(0, n, (n, k)), -1).astype(np.int32)
    new = np.where(rng.random((n, k)) < 0.3,
                   rng.integers(0, n, (n, k)), -1).astype(np.int32)
    new[:20] = old[:20]                           # fresh == old partners
    keep = rng.random((n, k)) < 0.7
    return new, old, keep


def test_topk_partners_and_merge_match_jax():
    new, old, keep = _tables()
    for k in (4, 8, 12):
        rd = cd_pallas.RowConflictData(*([None] * 8), torch.from_numpy(new),
                                       None)
        jrd = jtiled.RowConflictData(*([None] * 8), jnp.asarray(new), None)
        np.testing.assert_array_equal(
            cd_tiled.topk_partners(rd, k).numpy(),
            np.asarray(jtiled.topk_partners(jrd, k)))
    t = cd_tiled.merge_partners(torch.from_numpy(new), torch.from_numpy(old),
                                torch.from_numpy(keep))
    j = jtiled.merge_partners(jnp.asarray(new), jnp.asarray(old),
                              jnp.asarray(keep))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_partner_keep_matches_jax(dtype):
    _, old, _ = _tables()
    cols = columns(old.shape[0], "regional", seed=2)
    lat, lon, trk, _, _, _, gse, gsn, act, _ = cols
    args = [a.astype(dtype) for a in (lat, lon, gse, gsn, trk)]
    j = jtiled.partner_keep(jnp.asarray(old), *map(jnp.asarray, args),
                            jnp.asarray(act), RPZ, RPZ * 1.05)
    t = cd_tiled.partner_keep(torch.from_numpy(old),
                              *map(torch.from_numpy, args),
                              torch.from_numpy(act), RPZ, RPZ * 1.05)
    assert 0 < int(t.sum()) < int((old >= 0).sum())
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("geom", ["continental", "clusters"])
def test_build_candidates_matches_jax(geom):
    """Equal tables and overflow rows at N=1024, B=128 (nb=8), on the
    Morton-sorted columns, as the JAX candidate tests build them."""
    cols = columns(1024, geom)
    perm = np.asarray(jtiled.spatial_permutation(
        jnp.asarray(cols[0]), jnp.asarray(cols[1]), jnp.asarray(cols[8])))
    lat, lon, gs, act = (cols[i][perm] for i in (0, 1, 3, 8))
    for c_cap in (256, 768):
        jc, jo = jpallas._build_candidates(
            jnp.asarray(lat), jnp.asarray(lon), jnp.asarray(gs),
            jnp.asarray(act), 8, 128, c_cap, RPZ, TLOOK)
        tc, to = cd_pallas.build_candidates(
            torch.from_numpy(lat), torch.from_numpy(lon),
            torch.from_numpy(gs), torch.from_numpy(act), 8, 128, c_cap, RPZ,
            TLOOK)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tc.dtype == torch.int32 and tc.shape == (8, c_cap)


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors ``full_grid`` and ``cand_tiles`` return their plain
    versions' results and count no launch; the outputs hold the same
    function as the resume pass's first 10 outputs with nothing to
    resume, except that no conflict is filtered by the keep predicate."""
    x = _sorted_inputs(columns(N, "clusters"))
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(cr_mvp))
    cand, row_over = cd_pallas.build_candidates(
        x.lat, x.lon, x.gs, x.active, x.nb, x.block, 448, RPZ, TLOOK)
    before = dict(cd_pallas.LAUNCHES)
    for got, want in (
            (cd_pallas.full_grid(x.packed, x.reach, p),
             cd_pallas.full_grid_plain(x.packed, x.reach, p)),
            (cd_pallas.cand_tiles(x.packed, cand, p),
             cd_pallas.cand_tiles_plain(x.packed, cand, p))):
        assert len(got) == 10
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert dict(cd_pallas.LAUNCHES) == before
    # the candidate pass and the full grid agree on the rows that fit
    full = cd_pallas.full_grid_plain(x.packed, x.reach, p)
    cand_o = cd_pallas.cand_tiles_plain(x.packed, cand, p)
    fit = ~row_over
    sel = lambda outs: [o[fit] for o in outs]
    cd_pallas.compare_outputs("cand vs full", sel(cand_o), sel(full))


def test_compare_outputs_checks_the_ten_outputs():
    x = _sorted_inputs(columns(N, "regional"))
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(cr_mvp))
    want = cd_pallas.full_grid_plain(x.packed, x.reach, p)
    assert cd_pallas.compare_outputs("same", want, want) == 0.0
    valid = torch.nonzero(want[8] < cd_pallas._BIG)[0].tolist()
    for j, at, what in ((9, valid, "candidate sets"), (0, None, "inconf"),
                        (7, None, "lcnt"), (5, None, "tsolv")):
        got = [t.clone() for t in want]
        if at is None:
            got[j] += 1
        else:
            got[j][tuple(at)] = 10 ** 6
        with pytest.raises(AssertionError, match=what):
            cd_pallas.compare_outputs("changed", got, want)
    with pytest.raises(AssertionError, match="outputs"):
        cd_pallas.compare_outputs("short", want[:9], want)


def test_compare_rows_checks_ids_and_sums():
    """The candidate-vs-full-grid check of the card (``compare_rows``)
    passes equal results and names a changed top-K id or sum."""
    cols = [torch.from_numpy(a) for a in columns(N, "regional")]
    rd = cd_pallas.detect_resolve_pallas(*cols, RPZ, HPZ, TLOOK, _mvp(cr_mvp),
                                         block=BLOCK)
    cd_pallas.compare_rows("same", rd, rd)
    ids = rd.topk_idx.clone()
    ids[int(torch.nonzero(ids[:, 0] >= 0)[0, 0]), 0] += 1
    with pytest.raises(AssertionError, match="topk_idx"):
        cd_pallas.compare_rows("changed", rd._replace(topk_idx=ids), rd)
    with pytest.raises(AssertionError, match="sum_dve"):
        cd_pallas.compare_rows("changed", rd._replace(
            sum_dve=rd.sum_dve + 1.0), rd)


def test_swarm_with_candidates_raises():
    """Swarm with candidates raises, as in JAX; Eby with candidates runs
    and equals Eby without them."""
    cols = [torch.from_numpy(a) for a in columns(N, "clusters")]
    with pytest.raises(ValueError, match="swarm"):
        cd_pallas.detect_resolve_pallas(*cols, RPZ, HPZ, TLOOK, _mvp(cr_mvp),
                                        cand_cap=128, reso="swarm")
    extra = {"tas": cols[3] * 1.05}
    rd = cd_pallas.detect_resolve_pallas(*cols, RPZ, HPZ, TLOOK, _mvp(cr_mvp),
                                         block=BLOCK, cand_cap=448,
                                         reso="eby", extra_cols=extra)
    assert int(rd.nconf) > 0
    cd_pallas.compare_rows("eby cand_cap=448 vs 0", rd,
                           cd_pallas.detect_resolve_pallas(
                               *cols, RPZ, HPZ, TLOOK, _mvp(cr_mvp),
                               block=BLOCK, reso="eby", extra_cols=extra))


def _extra(cols, reso, seed=6):
    """The tas (Eby: 0.9-1.1 x gs) or cas (Swarm: 0.6-0.8 x gs) column."""
    rng = np.random.default_rng(seed)
    lo, hi = (0.9, 1.1) if reso == "eby" else (0.6, 0.8)
    key = "tas" if reso == "eby" else "cas"
    return key, (cols[3] * rng.uniform(lo, hi, len(cols[3]))).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_detect_reso(reso, cand_cap, key):
    @jax.jit
    def run(cols, extra):
        return jpallas.detect_resolve_pallas(
            *cols, RPZ, HPZ, TLOOK, _mvp(jmvp), block=BLOCK,
            interpret=True, cand_cap=cand_cap, reso=reso,
            extra_cols={key: extra})
    return run


@pytest.mark.parametrize("reso,geom,cand_cap", [
    ("eby", "continental", 0), ("eby", "regional", 0),
    ("eby", "clusters", 448), ("swarm", "continental", 0),
    ("swarm", "regional", 0)])
def test_resolver_forms_match_jax(reso, geom, cand_cap):
    """The Eby and Swarm forms of ``detect_resolve_pallas`` against JAX's
    in interpret mode: flags, counts and top-K ids equal; the MVP-side
    floats (and, for Swarm, the MVP sums) as the MVP test holds them; the
    seven Swarm sums within rtol 2e-4 / atol 2e-3; the Eby sums against
    the float64 witness (module docstring)."""
    cols = columns(N, geom)
    key, extra = _extra(cols, reso)
    j = _jax_detect_reso(reso, cand_cap, key)(
        [jnp.asarray(a) for a in cols], jnp.asarray(extra))
    t = cd_pallas.detect_resolve_pallas(
        *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, _mvp(cr_mvp),
        block=BLOCK, cand_cap=cand_cap, reso=reso,
        extra_cols={key: torch.from_numpy(extra)})
    if reso == "swarm":
        (j, jsw), (t, tsw) = j, t
        assert float(tsw[0].sum()) > 0
        for name, a, b in zip(cd_pallas.SWARM_SUMS, tsw, jsw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-3, err_msg=name)
        assert_rd_match(t, j, cols) in (set(), {351})
        return
    assert int(j.nconf) > 0
    for k in ("inconf", "nconf", "nlos", "topk_idx"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    for k in ("tcpamax", "tsolv", "topk_tin"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=2e-4,
                                   atol=2e-3, err_msg=k)
    s = slab64(cols, key, extra)
    n = s.shape[1]
    w = cd_pallas.row_block_plain(
        s, s, torch.arange(n), torch.arange(n), None,
        cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(cr_mvp)), "eby")
    ok = lambda a, b: np.isclose(a, b, rtol=2e-4, atol=2e-3)
    for k, idx in (("sum_dve", 2), ("sum_dvn", 3), ("sum_dvv", 4)):
        wit = w[idx].numpy()
        got, want = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        np.testing.assert_allclose(got, wit, rtol=2e-4, atol=2e-3,
                                   err_msg=f"{k} against float64")
        assert (ok(got, want) | ~ok(want, wit)).all(), k


@pytest.mark.parametrize("reso", ["eby", "swarm"])
def test_tile_body_float64(reso):
    """The plain tile body of the kernels (``row_block_plain``, the TAS
    velocity from the tas/gs ratio of the ``tr`` row) on float64 slabs
    against the JAX tiled backend in float64: the Eby sums within rtol
    1e-6 (the quadratic's cancellation on near-grazing pairs), the Swarm
    sums within rtol 1e-9 / atol 1e-9; flags and counts equal."""
    cols = columns(N, "regional")
    key, extra = _extra(cols, reso)
    c64 = [a.astype(np.float64) if a.dtype == np.float32 else a
           for a in cols]
    j = jtiled.detect_resolve_tiled(
        *[jnp.asarray(a) for a in c64], RPZ, HPZ, TLOOK, _mvp(jmvp),
        block=BLOCK, reso=reso,
        extra_cols={key: jnp.asarray(extra.astype(np.float64))})
    s = slab64(cols, key, extra)
    n = s.shape[1]
    w = cd_pallas.row_block_plain(
        s, s, torch.arange(n), torch.arange(n), None,
        cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(cr_mvp)), reso)
    if reso == "swarm":
        j, jsw = j
        for name, a, b in zip(cd_pallas.SWARM_SUMS, w[10:], jsw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-9, err_msg=name)
    assert int(w[6].sum()) == int(j.nconf) > 0
    np.testing.assert_array_equal(w[0].numpy() > 0.5, np.asarray(j.inconf))
    rtol = 1e-6 if reso == "eby" else 1e-9
    for k, idx in (("sum_dve", 2), ("sum_dvn", 3), ("sum_dvv", 4)):
        np.testing.assert_allclose(w[idx].numpy(), np.asarray(getattr(j, k)),
                                   rtol=rtol, atol=1e-9, err_msg=k)


def test_k16_partners_match_jax():
    """Fault C1: ``Traffic(k_partners=16)`` on the pallas backend keeps up
    to 16 fresh partners a row, as JAX does (200 aircraft of the clump at
    one altitude, block 64, one refresh and one interval; JAX in interpret
    mode).  On a CUDA tensor K = 16 passes the checks of a kernel launch,
    and so do K = 33 and 128 (the wide form: no fixed K is
    refused); a K whose CTA would pass the shared memory a CTA may hold
    raises, naming the bytes it would take."""
    from bluesky_tpu.core.traffic import Traffic as JTraffic
    from bluesky_tpu_torch.core import asas as tasas
    from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
    from torch_parity import scene
    lat, lon, hdg, alt, spd = scene(200, "clump", 3)
    alt = np.full_like(alt, 9500.0)
    jt = JTraffic(nmax=256, pair_matrix=False, k_partners=16)
    tt = TTraffic(nmax=256, pair_matrix=False, k_partners=16, device="cpu")
    for tr in (jt, tt):
        tr.create(200, "B744", alt, spd, None, lat, lon, hdg)
        tr.flush()
    with jax.default_device(jax.devices("cpu")[0]):
        js = jasas.refresh_spatial_sort(jt.state, jasas.AsasConfig(),
                                        block=BLOCK, impl="pallas")
        js, _ = jasas.update_tiled(js, jasas.AsasConfig(), block=BLOCK,
                                   impl="pallas")
    ts = tasas.refresh_spatial_sort(tt.state, tasas.AsasConfig(),
                                    block=BLOCK, impl="pallas")
    ts, _ = tasas.update_tiled(ts, tasas.AsasConfig(), block=BLOCK,
                               impl="pallas")
    jp, tp = np.asarray(js.asas.partners), ts.asas.partners.numpy()
    assert tp.shape == (256, 16)
    assert int(((tp >= 0).sum(1) > 8).sum()) > 100
    from torch_parity import partner_sets
    assert partner_sets(tp) == partner_sets(jp)
    assert int(ts.asas.nconf_cur) == int(js.asas.nconf_cur)

    class OnCard(torch.Tensor):
        """A tensor that reports itself on a CUDA device."""
        @property
        def is_cuda(self):
            return True

    x = _sorted_inputs(columns(N, "regional"))
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, _mvp(cr_mvp))
    packed = x.packed.as_subclass(OnCard)
    pold = torch.full((x.nb, 16, x.block), -1,
                      dtype=torch.int32).as_subclass(OnCard)
    assert cd_pallas.check_common(packed, kk=16) == (x.nb, x.block)
    assert cd_pallas.check_common(packed, pold) == (x.nb, x.block)
    for kk in (33, 128):
        assert cd_pallas.check_common(packed, kk=kk) == (x.nb, x.block)
    smem = cd_pallas.cta_shared_bytes(20000, x.block, ids=True)
    assert smem > cd_pallas.MAX_CTA_SHARED
    with pytest.raises(ValueError, match=f"K = 20000 partners at B = "
                                         f"{x.block} take {smem} bytes of "
                                         f"shared memory"):
        cd_pallas.check_common(packed, kk=20000)
    with pytest.raises(ValueError, match=r"K = 20000 .* \d+ bytes"):
        cd_pallas.full_grid_resume(
            packed, x.reach, torch.full((x.nb, 20000, x.block), -1,
                                        dtype=torch.int32), p)
