"""The hand-written CUDA kernels against their plain PyTorch versions on
a CUDA device (marker ``gpu``; skipped where there is none), and the
candidate mode of ``detect_resolve_pallas`` against its full grid:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Flags, counts, keep bits, candidate and merged partner sets equal; the
float reductions within rtol 1e-4 / atol 5e-3 (the same check as
``chip_smoke.py``: ``cd_pallas.compare_outputs``).
"""
import numpy as np
import pytest
import torch

from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled, cr_mvp

from torch_parity import FT, NM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(geom, n, dev):
    rng = np.random.default_rng(3)
    if geom == "clump":
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 3.8 * np.sqrt(rng.random(n))
        lat, lon = 52.6 + r * np.cos(ang), 5.4 + r * np.sin(ang) / 0.6
    elif geom == "clusters":
        centers = np.array([(45 + 5 * (i // 4), -5 + 5 * (i % 4))
                            for i in range(8)])[rng.integers(0, 8, n)]
        lat = centers[:, 0] + rng.normal(0, 0.3, n)
        lon = centers[:, 1] + rng.normal(0, 0.4, n)
    else:
        lat, lon = rng.uniform(35, 60, n), rng.uniform(-10, 30, n)
    gs, trk = rng.uniform(130, 240, n), rng.uniform(0, 360, n)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return [f(lat), f(lon), f(trk), f(gs), f(rng.uniform(3000, 11000, n)),
            f(rng.uniform(-15, 15, n)), f(gs * np.sin(np.radians(trk))),
            f(gs * np.cos(np.radians(trk))),
            torch.as_tensor(rng.random(n) > 0.05, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev)]


@pytest.mark.parametrize("geom,s_cap", [("spread", 6), ("clump", 2)])
def test_kernels_match_plain(cuda, geom, s_cap):
    n = 4096
    n_tot = cd_sched.padded_size(n, 256)
    x = cd_sched.prepare(*_inputs(geom, n, cuda), 5 * NM, 1000 * FT, 300.0,
                         torch.full((n_tot, 8), -1, dtype=torch.int32,
                                    device=cuda), block=256, s_cap=s_cap)
    cfg = cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                           tlookahead=300.0)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, cfg, 5 * NM * 1.05)
    reach_f = x.reach & x.overflow[:, None]
    n1 = cd_sched.LAUNCHES["cd_sched_tiles"]
    n2 = cd_pallas.LAUNCHES["cd_full_grid_resume"]
    pairs = [
        (cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p),
         cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax, x.pold,
                                    p)),
        (cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p),
         cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold, p))]
    torch.cuda.synchronize()
    assert cd_sched.LAUNCHES["cd_sched_tiles"] == n1 + 1
    assert cd_pallas.LAUNCHES["cd_full_grid_resume"] == n2 + 1
    if geom == "clump":
        assert int(x.overflow.sum()) > 0
    for name, (got, want) in zip(("sched", "resume"), pairs):
        cd_pallas.compare_outputs(f"{name} {geom}", got, want)


def _mvp():
    return cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                            tlookahead=300.0)


def _sorted(cols):
    perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8])
    return cd_pallas.prepare(*[a[perm] for a in cols], 5 * NM, 300.0,
                             block=256)


@pytest.mark.parametrize("geom", ["spread", "clump"])
def test_full_grid_matches_plain(cuda, geom):
    """``cd_full_grid`` (``_kernel``) in Morton order."""
    x = _sorted(_inputs(geom, 4096, cuda))
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    n0 = cd_pallas.LAUNCHES["cd_full_grid"]
    got = cd_pallas.full_grid(x.packed, x.reach, p)
    torch.cuda.synchronize()
    assert cd_pallas.LAUNCHES["cd_full_grid"] == n0 + 1
    cd_pallas.compare_outputs(f"full grid {geom}", got,
                              cd_pallas.full_grid_plain(x.packed, x.reach, p))


@pytest.mark.parametrize("cap", [2048, 1024])
def test_cand_tiles_match_plain(cuda, cap):
    """``cand_tiles`` (``_kernel_cand``) on eight clusters, and
    ``detect_resolve_pallas`` with candidates (launching both kernels)
    against the one without."""
    cols = _inputs("clusters", 8192, cuda)
    x = _sorted(cols)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    cand, row_over = cd_pallas.build_candidates(
        x.lat, x.lon, x.gs, x.active, x.nb, x.block, cap, 5 * NM, 300.0)
    assert 0 < int(row_over.sum()) < x.nb
    cd_pallas.compare_outputs(f"cand tiles {cap}",
                              cd_pallas.cand_tiles(x.packed, cand, p),
                              cd_pallas.cand_tiles_plain(x.packed, cand, p))
    n0 = dict(cd_pallas.LAUNCHES)
    rd = cd_pallas.detect_resolve_pallas(*cols, 5 * NM, 1000 * FT, 300.0,
                                         _mvp(), block=256, cand_cap=cap)
    assert cd_pallas.LAUNCHES["cd_cand_tiles"] == n0["cd_cand_tiles"] + 1
    assert cd_pallas.LAUNCHES["cd_full_grid"] == n0["cd_full_grid"] + 1
    cd_pallas.compare_rows(f"cand_cap={cap} vs 0", rd,
                           cd_pallas.detect_resolve_pallas(
                               *cols, 5 * NM, 1000 * FT, 300.0, _mvp(),
                               block=256))


def _split_check(name, launches, kern, want, items):
    """``kern(per_row)`` at two items per row (twice) and at the default
    against the plain outputs ``want``: the two split launches bit-equal,
    the top-K ids in order, one launch counted per call."""
    assert int((items.length > 0).sum(1).eq(2).sum()) > 0
    n0 = launches[name]
    first, again, whole = kern(2), kern(2), kern(None)
    torch.cuda.synchronize()
    assert launches[name] == n0 + 3
    cd_pallas.compare_outputs(f"{name} split", first, want)
    cd_pallas.compare_outputs(name, whole, want)
    for a, b in zip(first, again):
        assert torch.equal(a, b), f"{name}: two launches differ"
    # the top-K ids in order, not just as sets
    assert torch.equal(first[9].cpu(), want[9].cpu())


def _per_row(fn):
    """``fn`` called with ``per_row=c``, or with its default for None."""
    return lambda c: fn() if c is None else fn(per_row=c)


@pytest.mark.parametrize("geom,s_cap", [("spread", 6), ("clump", 2)])
def test_split_walkers_match_plain_and_repeat(cuda, geom, s_cap):
    """``cd_sched_tiles`` and ``cd_full_grid`` with at most two work items
    per row (most rows split) against their plain versions; a second
    launch on the same inputs gives the same outputs bit for bit, and
    each wrapper call counts one launch."""
    cols = _inputs(geom, 4096, cuda)
    n_tot = cd_sched.padded_size(4096, 256)
    x = cd_sched.prepare(*cols, 5 * NM, 1000 * FT, 300.0,
                         torch.full((n_tot, 8), -1, dtype=torch.int32,
                                    device=cuda), block=256, s_cap=s_cap)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp(), 5 * NM * 1.05)
    xp = _sorted(cols)
    pp = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    _split_check(
        "cd_sched_tiles", cd_sched.LAUNCHES,
        _per_row(lambda **kw: cd_sched.sched_tiles(
            x.packed, x.wst, x.wln, x.wmax, x.pold, p, **kw)),
        cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax, x.pold,
                                   p),
        cd_sched.window_items(x.wst, x.wln, x.wmax, x.nb, 2))
    _split_check(
        "cd_full_grid", cd_pallas.LAUNCHES,
        _per_row(lambda **kw: cd_pallas.full_grid(xp.packed, xp.reach, pp,
                                                  **kw)),
        cd_pallas.full_grid_plain(xp.packed, xp.reach, pp),
        cd_pallas.reach_items(xp.reach, 2))


def test_split_overflow_walker_matches_plain_and_repeat(cuda):
    """``full_grid_resume`` (``_kernel_resume``: ``cd_sched_tiles`` on
    the reachable blocks of the overflow rows) on the clump, where rows
    overflow at ``s_cap=2``."""
    x = cd_sched.prepare(*_inputs("clump", 4096, cuda), 5 * NM, 1000 * FT,
                         300.0, torch.full((cd_sched.padded_size(4096, 256),
                                            8), -1, dtype=torch.int32,
                                           device=cuda), block=256, s_cap=2)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp(), 5 * NM * 1.05)
    reach_f = x.reach & x.overflow[:, None]
    assert int(x.overflow.sum()) > 0
    _split_check(
        "cd_full_grid_resume", cd_pallas.LAUNCHES,
        _per_row(lambda **kw: cd_pallas.full_grid_resume(
            x.packed, reach_f, x.pold, p, **kw)),
        cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold, p),
        cd_pallas.reach_items(reach_f, 2))


@pytest.mark.parametrize("cap", [2048, 1024])
def test_split_cand_walker_matches_plain_and_repeat(cuda, cap):
    """``cand_tiles`` (``_kernel_cand``: ``cd_cand_items`` on the
    sub-chunks of each row's candidate table) on eight clusters."""
    x = _sorted(_inputs("clusters", 8192, cuda))
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    cand, _ = cd_pallas.build_candidates(
        x.lat, x.lon, x.gs, x.active, x.nb, x.block, cap, 5 * NM, 300.0)
    _split_check(
        "cd_cand_tiles", cd_pallas.LAUNCHES,
        _per_row(lambda **kw: cd_pallas.cand_tiles(x.packed, cand, p, **kw)),
        cd_pallas.cand_tiles_plain(x.packed, cand, p),
        cd_pallas.cand_items(cand, x.block, 2))


def test_mask_items_match_plain(cuda):
    """``cd_mask_items`` (the work items of a row mask, built on the card)
    against its plain version on the CPU: starts, lengths, launch order
    and each row's tiles equal, for masks wider than a CTA and more rows
    than one CTA of the launch-order kernel."""
    rng = np.random.default_rng(5)
    for nb, w, dens in ((7, 5, 0.5), (392, 392, 0.1), (40, 600, 0.7),
                        (520, 64, 0.3)):
        mask = torch.as_tensor(rng.random((nb, w)) < dens)
        mask[0] = False
        for c in (1, 2, 8, 16):
            got = [t.cpu() for t in cd_pallas.mask_items(mask.to(cuda), c)]
            want = cd_pallas.mask_items(mask, c)
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a, b)
            valid = torch.arange(w)[None, :] < mask.sum(1)[:, None]
            assert torch.equal(got[0][valid], want.tiles[valid])


def _reso_extra(cols, reso):
    """The tas (Eby) or cas (Swarm) column of ``cols``, from a numpy seed:
    tas 0.9-1.1 x gs, cas 0.6-0.8 x gs."""
    rng = np.random.default_rng(11)
    f = rng.uniform(0.9, 1.1, cols[3].shape[0]) if reso == "eby" \
        else rng.uniform(0.6, 0.8, cols[3].shape[0])
    return cols[3] * torch.as_tensor(f, dtype=torch.float32,
                                     device=cols[3].device)


@pytest.mark.parametrize("reso", ["eby", "swarm"])
@pytest.mark.parametrize("geom,s_cap", [("spread", 6), ("clump", 2)])
def test_resolver_forms_match_plain(cuda, reso, geom, s_cap):
    """The Eby and Swarm forms of ``cd_sched_tiles`` (K1, and K2 on the
    overflow rows) and of ``cd_full_grid`` (K3) against their plain
    versions, each call counting one launch of its form."""
    cols = _inputs(geom, 4096, cuda)
    extra = _reso_extra(cols, reso)
    n_tot = cd_sched.padded_size(4096, 256)
    x = cd_sched.prepare(*cols, 5 * NM, 1000 * FT, 300.0,
                         torch.full((n_tot, 8), -1, dtype=torch.int32,
                                    device=cuda), block=256, s_cap=s_cap,
                         tas=extra if reso == "eby" else None,
                         cas=extra if reso == "swarm" else None, reso=reso)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp(), 5 * NM * 1.05)
    reach_f = x.reach & x.overflow[:, None]
    perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8])
    xp = cd_pallas.prepare(*[a[perm] for a in cols], 5 * NM, 300.0,
                           block=256, reso=reso,
                           extra_cols={"tas" if reso == "eby" else "cas":
                                       extra[perm]})
    pp = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    key = lambda name: cd_pallas.launch_key(name, reso)
    n0 = (cd_sched.LAUNCHES[key("cd_sched_tiles")],
          cd_pallas.LAUNCHES[key("cd_full_grid_resume")],
          cd_pallas.LAUNCHES[key("cd_full_grid")])
    runs = [
        ("sched", lambda: cd_sched.sched_tiles(
            x.packed, x.wst, x.wln, x.wmax, x.pold, p, reso=reso),
         lambda: cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                            x.pold, p, reso)),
        ("resume", lambda: cd_pallas.full_grid_resume(
            x.packed, reach_f, x.pold, p, reso=reso),
         lambda: cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold,
                                                  p, reso)),
        ("full grid", lambda: cd_pallas.full_grid(xp.packed, xp.reach, pp,
                                                  reso=reso),
         lambda: cd_pallas.full_grid_plain(xp.packed, xp.reach, pp, reso))]
    for name, kern, plain in runs:
        got = kern()
        cd_pallas.compare_outputs(f"{name} {reso} {geom}", got, plain())
        assert torch.equal(kern()[9], got[9])
    torch.cuda.synchronize()
    assert (cd_sched.LAUNCHES[key("cd_sched_tiles")],
            cd_pallas.LAUNCHES[key("cd_full_grid_resume")],
            cd_pallas.LAUNCHES[key("cd_full_grid")]) == tuple(
                k + 2 for k in n0)
    if geom == "clump":
        assert int(x.overflow.sum()) > 0
    if reso == "swarm":
        assert float(got[10].sum()) > 0      # swarm neighbours were found


def test_eby_cand_tiles_match_plain(cuda):
    """The Eby form of ``cand_tiles`` (K4) on eight clusters; the Swarm
    form of the candidate pass raises, as in the JAX package."""
    cols = _inputs("clusters", 8192, cuda)
    tas = _reso_extra(cols, "eby")
    perm = cd_tiled.spatial_permutation(cols[0], cols[1], cols[8])
    x = cd_pallas.prepare(*[a[perm] for a in cols], 5 * NM, 300.0,
                          block=256, reso="eby", extra_cols={"tas": tas[perm]})
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    cand, row_over = cd_pallas.build_candidates(
        x.lat, x.lon, x.gs, x.active, x.nb, x.block, 2048, 5 * NM, 300.0)
    assert 0 < int(row_over.sum()) < x.nb
    n0 = cd_pallas.LAUNCHES["cd_cand_tiles_eby"]
    cd_pallas.compare_outputs(
        "cand tiles eby", cd_pallas.cand_tiles(x.packed, cand, p, reso="eby"),
        cd_pallas.cand_tiles_plain(x.packed, cand, p, "eby"))
    assert cd_pallas.LAUNCHES["cd_cand_tiles_eby"] == n0 + 1
    with pytest.raises(ValueError, match="swarm"):
        cd_pallas.cand_tiles(x.packed, cand, p, reso="swarm")


def test_swarm_track_wrap_on_the_card(cuda):
    """The Swarm neighbour test on pairs whose track difference lies near
    -180, +180, -90 and +90 deg: the kernel's floored modulo gives the
    plain version's (``torch.remainder``) neighbour sums."""
    n = 512
    rng = np.random.default_rng(2)
    base = rng.uniform(0.0, 360.0, n // 2)
    dt = rng.choice([-180.0, 180.0, -90.0, 90.0], n // 2) \
        + rng.uniform(-1e-3, 1e-3, n // 2)
    trk = np.stack([base, np.mod(base + dt, 360.0)], 1).reshape(-1)
    lat = np.repeat(rng.uniform(52.0, 52.5, n // 2), 2) \
        + rng.uniform(0, 0.02, n)
    lon = np.repeat(rng.uniform(4.0, 4.8, n // 2), 2) \
        + rng.uniform(0, 0.02, n)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    gs = np.full(n, 200.0)
    cols = [f(lat), f(lon), f(trk), f(gs), f(np.full(n, 9000.0)),
            f(np.zeros(n)), f(gs * np.sin(np.radians(trk))),
            f(gs * np.cos(np.radians(trk))),
            torch.ones(n, dtype=torch.bool, device=cuda),
            torch.zeros(n, dtype=torch.bool, device=cuda)]
    x = cd_pallas.prepare(*cols, 5 * NM, 300.0, block=128, reso="swarm",
                          extra_cols={"cas": f(gs * 0.7)})
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    got = cd_pallas.full_grid(x.packed, x.reach, p, reso="swarm")
    want = cd_pallas.full_grid_plain(x.packed, x.reach, p, "swarm")
    cd_pallas.compare_outputs("swarm track wrap", got, want)
    assert float(want[10].sum()) > 0


@pytest.mark.parametrize("kk", [1, 3, 16, 32, 33, 64, 128])
def test_partner_width_kernels_match_plain(cuda, kk):
    """Every walker at partner width ``kk`` (the run-time form of the
    kernels up to K = 32, the wide form past it; K = 8 is their constant
    form) against its plain version:
    ``cd_sched_tiles`` and the overflow pass on the clump at ``s_cap=2``
    with the K-wide table of a first interval, ``cd_full_grid`` in
    Morton order and ``cd_cand_items`` on the clusters."""
    n = 4096
    n_tot = cd_sched.padded_size(n, 256)
    p = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp(), 5 * NM * 1.05)
    pp = cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, _mvp())
    cols = _inputs("clump", n, cuda)
    table = torch.full((n_tot, kk), -1, dtype=torch.int32, device=cuda)
    x = cd_sched.prepare(*cols, 5 * NM, 1000 * FT, 300.0, table, block=256,
                         s_cap=2)
    table = cd_sched.run_kernels(x, p)[11].transpose(1, 2) \
        .reshape(n_tot, kk).contiguous()
    x = cd_sched.prepare(*cols, 5 * NM, 1000 * FT, 300.0, table, block=256,
                         s_cap=2, perm=x.perm)
    reach_f = x.reach & x.overflow[:, None]
    assert int(x.overflow.sum()) > 0
    cd_pallas.compare_outputs(
        f"sched K={kk}",
        cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, x.pold, p),
        cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax, x.pold,
                                   p))
    cd_pallas.compare_outputs(
        f"resume K={kk}",
        cd_pallas.full_grid_resume(x.packed, reach_f, x.pold, p),
        cd_pallas.full_grid_resume_plain(x.packed, reach_f, x.pold, p))
    xs = _sorted(cols)
    got = cd_pallas.full_grid(xs.packed, xs.reach, pp, kk=kk)
    assert got[9].shape[1] == kk
    cd_pallas.compare_outputs(
        f"full grid K={kk}", got,
        cd_pallas.full_grid_plain(xs.packed, xs.reach, pp, kk=kk))
    xc = _sorted(_inputs("clusters", 8192, cuda))
    cand, _ = cd_pallas.build_candidates(xc.lat, xc.lon, xc.gs, xc.active,
                                         xc.nb, xc.block, 2048, 5 * NM, 300.0)
    cd_pallas.compare_outputs(
        f"cand tiles K={kk}", cd_pallas.cand_tiles(xc.packed, cand, pp, kk=kk),
        cd_pallas.cand_tiles_plain(xc.packed, cand, pp, kk=kk))


@pytest.mark.parametrize("reso,kk", [("mvp", 8), ("eby", 8), ("swarm", 8),
                                     ("mvp", 16), ("mvp", 64)])
def test_mesh_forms_match_plain(cuda, reso, kk):
    """The walker's mesh forms (ROADMAP B3) against their plain versions
    and the row subsets against the one-card launch's rows: K1's row
    subset, ``col0`` window and gid table, K2's and K3's row subset and
    window, on the check shapes of ``chip_smoke.check_mesh_forms``
    (fleets divided by 4)."""
    import chip_smoke
    errs = {}
    chip_smoke.check_mesh_forms(cuda, errs, reso, kk, scale=4)
    assert len(errs) == 7
