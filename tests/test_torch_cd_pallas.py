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

from torch_parity import FT, NM

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
    cols = [torch.from_numpy(a) for a in columns(N, "regional")]
    with pytest.raises(ValueError, match="swarm"):
        cd_pallas.detect_resolve_pallas(*cols, RPZ, HPZ, TLOOK, _mvp(cr_mvp),
                                        cand_cap=128, reso="swarm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cd_pallas.detect_resolve_pallas(*cols, RPZ, HPZ, TLOOK, _mvp(cr_mvp),
                                        reso="eby")
