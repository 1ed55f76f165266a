"""Partner tables K wide (``Traffic(k_partners=K)``, ROADMAP B2) on the
port's blockwise backends against the JAX package, on the CPU: the plain
versions of the kernels in the port, JAX's sparse kernel in interpret
mode.

* The clump of ``test_torch_cd_pallas.test_k16_partners_match_jax``
  (200 aircraft within 0.6 deg at one altitude in 256 slots, block 64;
  more than 100 rows hold more than 8 partners at K = 16): one sort
  refresh and one ASAS interval of the sparse backend against JAX's
  sparse (MVP), and of the tiled backend against JAX's tiled under MVP,
  EBY, SWARM and SSD.  The sort, the partner sets, nconf, nlos and the
  conflict and ASAS flags are equal; the pair sums and the ASAS commands
  within rtol 2e-4 / atol 2e-3 (float32 CD: the tolerance of
  ``test_torch_cd_pallas``).  A sum that misses it is held to the
  second witness of that file, the ownship's sums recomputed in float64
  from the same float32 inputs (``row_block_plain`` on ``slab64``),
  within the same tolerance: in the clump a row sums up to ~40 MVP
  displacements in float32, in another order in each package, and on
  row 28 of the sparse interval the port lies 1.6e-4 below the witness
  and JAX 1.3e-4 above it.  Under MVP, SWARM and SSD at most two rows
  may need the witness, and their commands are left out.  Under EBY
  JAX's float32 Eby pair moves the sums of many rows (ROADMAP §C), which
  the port, computing the pair in float64, does not: every Eby sum is
  held to JAX or the witness, and the Eby commands are not compared.
* SSD from the K = 16 table of the sparse interval: the port's
  ``cr_ssd.resolve_from_partners`` against JAX's on the same float64
  inputs and table, within rtol 1e-9.
* Two stacked worlds at K = 16 (sparse) step bit for bit as their solo
  runs.
* The plain versions at K = 1, 3, 32, 33, 64 and 128 (the reach-masked
  full grid of ``_kernel`` and the segment pass of ``_sched_kernel``):
  JAX would compile each K anew, so they are held against the float64
  witness, ``cd_pallas.row_block_plain`` on ``torch_parity.slab64``: the
  top-K and merged partner sets equal.  The densest row of that clump
  conflicts with more than 32 others, fewer than 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import asas as jasas
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu.ops import cr_ssd as jssd
from bluesky_tpu_torch.core import asas as tasas, graph, step as tstep
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled, cr_mvp, \
    cr_ssd as tssd

from torch_parity import (FT, NM, jax_tree_to_numpy, partner_sets, scene,
                          slab64)

K, NMAX, N, BLOCK = 16, 256, 200, 64
RTOL, ATOL = 2e-4, 2e-3


def _clump_inputs(seed=3):
    lat, lon, hdg, alt, spd = scene(N, "clump", seed)
    return lat, lon, hdg, np.full_like(alt, 9500.0), spd


def _traffic(cls, kk=K, seed=3, lat_shift=0.0, **kw):
    lat, lon, hdg, alt, spd = _clump_inputs(seed)
    t = cls(nmax=NMAX, pair_matrix=False, k_partners=kk, **kw)
    t.create(N, "B744", alt, spd, None, lat + lat_shift, lon, hdg)
    t.flush()
    return t


def _interval(impl, reso="MVP"):
    """One refresh and one interval on the clump in both packages:
    ``((jax state, jax rd), (port state, port rd, float64 witness), port
    state)``, on numpy but the last."""
    jcfg = jasas.AsasConfig(reso_method=reso)
    tcfg = tasas.AsasConfig(reso_method=reso)
    with jax.default_device(jax.devices("cpu")[0]):
        js = jasas.refresh_spatial_sort(_traffic(JTraffic).state, jcfg,
                                        block=BLOCK, impl=impl)
        js, jrd = jasas.update_tiled(js, jcfg, block=BLOCK, impl=impl)
    ts0 = tasas.refresh_spatial_sort(_traffic(TTraffic, device="cpu").state,
                                     tcfg, block=BLOCK, impl=impl)
    ts, trd = tasas.update_tiled(ts0, tcfg, block=BLOCK, impl=impl)
    return (jax_tree_to_numpy(js), jax.tree_util.tree_map(np.asarray, jrd)), \
        (state_to_numpy(ts), [np.asarray(a) for a in trd],
         _witness(ts0, tcfg)), ts


def _witness(state, cfg):
    """The float64 witness of an interval's pair sums: every ownship of
    ``state`` against every aircraft (the reachability only skips pairs
    that cannot conflict) in the resolver's form of the tile body."""
    ac = state.ac
    cols = [a.numpy() for a in (ac.lat, ac.lon, ac.trk, ac.gs, ac.alt, ac.vs,
                                ac.gseast, ac.gsnorth, ac.active,
                                state.asas.noreso)]
    form = {"EBY": "eby", "SWARM": "swarm"}.get(cfg.reso_method, "mvp")
    s64 = slab64(cols, "cas" if form == "swarm" else "tas",
                 (ac.cas if form == "swarm" else ac.tas).numpy())
    gid = torch.arange(NMAX)
    p = cd_pallas.tile_params(cfg.rpz, cfg.hpz, cfg.dtlookahead,
                              tasas._mvp_config(cfg))
    return [a.numpy() for a in cd_pallas.row_block_plain(
        s64, s64, gid, gid, None, p, form)]


def _assert_interval(j, t, table, eby=False):
    (js, jrd), (ts, trd, wit) = j, t
    assert ts[table].shape[1] == K
    assert int(((ts[table] >= 0).sum(1) > 8).sum()) > 100
    assert partner_sets(ts[table]) == partner_sets(js[table])
    for k in ("asas.sort_perm", "asas.nconf_cur", "asas.nlos_cur",
              "asas.inconf", "asas.active"):
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    jd, td = dict(zip(jrd._fields, jrd)), dict(zip(jrd._fields, trd))
    close = lambda a, b: np.isclose(a, b, rtol=RTOL, atol=ATOL)
    witnessed = np.zeros(NMAX, bool)
    for k, i in (("tcpamax", 1), ("sum_dve", 2), ("sum_dvn", 3),
                 ("sum_dvv", 4), ("tsolv", 5)):
        got, want, w = td[k], jd[k], wit[i]
        ok = close(got, want)
        assert (ok | close(got, w)).all(), \
            (k, np.flatnonzero(~(ok | close(got, w))))
        witnessed |= ~ok
    if eby:
        return
    assert int(witnessed.sum()) <= 2, np.flatnonzero(witnessed)
    for k in ("asas.trk", "asas.tas", "asas.vs", "asas.alt"):
        np.testing.assert_allclose(ts[k][~witnessed], js[k][~witnessed],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def sparse16():
    return _interval("sparse")


def test_sparse_k16_matches_jax(sparse16):
    """The sparse backend at K = 16: the in-kernel merged sorted-space
    table ``partners_s`` holds JAX's sets."""
    j, t, _ = sparse16
    _assert_interval(j, t, "asas.partners_s")


def test_ssd_from_k16_table_matches_jax(sparse16):
    """SSD from the caller-space K = 16 table of the sparse interval, in
    float64, against JAX's ``resolve_from_partners`` on the same
    inputs."""
    _, (ts, _, _), state = sparse16
    table = cd_sched.partners_to_caller(
        state.asas.sort_perm, state.asas.partners_s[:cd_sched.padded_size(
            NMAX, BLOCK)], NMAX, cd_sched.padded_size(NMAX, BLOCK)).numpy()
    assert int(((table >= 0).sum(1) > 8).sum()) > 100
    ac = {k: ts[f"ac.{k}"].astype(np.float64) if ts[f"ac.{k}"].dtype
          == np.float32 else ts[f"ac.{k}"]
          for k in ("lat", "lon", "alt", "trk", "gs", "vs", "gseast",
                    "gsnorth", "active", "hdg")}
    inconf = ts["asas.inconf"]
    c = tasas.AsasConfig(reso_method="SSD")
    got = tssd.resolve_from_partners(
        torch.from_numpy(table), torch.from_numpy(inconf),
        *[torch.from_numpy(ac[k]) for k in ("lat", "lon", "alt", "trk",
                                            "gs", "vs", "gseast",
                                            "gsnorth", "active")],
        c.vmin, c.vmax, tasas._ssd_config(c),
        hdg=torch.from_numpy(ac["hdg"]))
    with jax.default_device(jax.devices("cpu")[0]):
        want = jssd.resolve_from_partners(
            jnp.asarray(table), jnp.asarray(inconf),
            *[jnp.asarray(ac[k]) for k in ("lat", "lon", "alt", "trk", "gs",
                                           "vs", "gseast", "gsnorth",
                                           "active")],
            c.vmin, c.vmax, jssd.SSDConfig(rpz_m=c.rpz_m,
                                           tlookahead=c.dtlookahead,
                                           priocode="RS1"),
            hdg=jnp.asarray(ac["hdg"]))
    moved = np.asarray(want[0]) != ac["trk"]
    assert int((moved & inconf).sum()) > 50
    for g, w, name in zip(got, want, ("trk", "gs")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("reso", ["MVP", "EBY", "SWARM", "SSD"])
def test_tiled_k16_matches_jax(reso):
    """The tiled backend at K = 16 under each resolver: the caller-space
    table ``partners`` holds JAX's sets (SSD resolves from it)."""
    j, t, _ = _interval("lax", reso)
    _assert_interval(j, t, "asas.partners", eby=reso == "EBY")


def test_k16_worlds_bit_equal_solo():
    """Two stacked sparse worlds at K = 16 (the clump, and another clump
    1 deg north from another seed), 21 steps (two ASAS intervals), equal
    their solo runs bit for bit."""
    cfg = tstep.SimConfig(cd_backend="sparse", cd_block=BLOCK)
    states = [tasas.refresh_spatial_sort(
        _traffic(TTraffic, seed=s, lat_shift=d, device="cpu").state,
        cfg.asas, block=BLOCK, impl="sparse") for s, d in ((3, 0.0),
                                                           (4, 1.0))]
    copy = lambda st: graph.rebuild(st, iter([x.clone() for _, x in
                                              graph.leaves(st)]))
    solo = [tstep.run_steps(copy(s), cfg, 21) for s in states]
    got = tstep.unstack_worlds(tstep.run_steps_worlds(
        tstep.stack_worlds(states), cfg, 21))
    for ref, g in zip(solo, got):
        a, b = state_to_numpy(ref), state_to_numpy(g)
        assert a["asas.partners_s"].shape[1] == K
        assert int(((a["asas.partners_s"] >= 0).sum(1) > 8).sum()) > 50
        bad = [k for k in a if not np.array_equal(a[k], b[k],
                                                  equal_nan=True)]
        assert not bad, bad


def _columns():
    """The clump's CD columns, drawn in to half its radius (caller order,
    float32; 5 % inactive)."""
    lat, lon, hdg, alt, spd = _clump_inputs()
    lat, lon = 52.6 + (lat - 52.6) * 0.5, 5.4 + (lon - 5.4) * 0.5
    rng = np.random.default_rng(7)
    f = lambda a: np.asarray(a, np.float32)
    trk = np.radians(f(hdg))
    act = rng.random(N) > 0.05
    return [f(lat), f(lon), f(hdg), f(spd), f(alt), f(rng.uniform(-2, 2, N)),
            f(f(spd) * np.sin(trk)), f(f(spd) * np.cos(trk)), act,
            np.zeros(N, bool)]


def _params():
    mvp = cr_mvp.MVPConfig(rpz_m=5 * NM * 1.05, hpz_m=1000 * FT * 1.05,
                           tlookahead=300.0)
    return cd_pallas.tile_params(5 * NM, 1000 * FT, 300.0, mvp,
                                 5 * NM * 1.05)


def _sets(ids, valid):
    return [frozenset(r[v].tolist()) for r, v in zip(ids.T, valid.T)]


@pytest.mark.parametrize("kk", [1, 3, 32, 33, 64, 128])
def test_plain_top_k_against_float64_witness(kk):
    """The plain full grid (``_kernel``) and segment pass
    (``_sched_kernel`` with its overflow fallback, a fresh partner table)
    at K = ``kk`` on the clump:
    each row's top-K candidate ids, and the segment pass's merged
    partners, are those of the float64 witness."""
    cols = _columns()
    p = _params()
    t = [torch.from_numpy(a) for a in cols]
    perm = cd_tiled.spatial_permutation(t[0], t[1], t[8])
    x = cd_pallas.prepare(*[a[perm] for a in t], 5 * NM, 300.0, block=BLOCK)
    got = cd_pallas.full_grid_plain(x.packed, x.reach, p, kk=kk)
    nt = x.nb * x.block
    cidx = got[9].transpose(0, 1).reshape(kk, nt)[:, :N].numpy()
    ctin = got[8].transpose(0, 1).reshape(kk, nt)[:, :N].numpy()
    s64 = slab64([a[perm.numpy()] for a in cols], "tas",
                 cols[3][perm.numpy()])
    gid = torch.arange(N)
    w = cd_pallas.row_block_plain(s64, s64, gid, gid, None, p, kk=kk)
    # the densest row's conflicts: the top-K is full there up to K = 33,
    # and past it every row keeps all its candidates
    widest = int(w[6].max())
    assert widest > 32
    assert int((w[8] < 1e9).sum(0).max()) == min(kk, widest)
    assert _sets(cidx, ctin < 1e9) == _sets(w[9].numpy(), w[8].numpy() < 1e9)

    n_tot = cd_sched.padded_size(N, BLOCK)
    xs = cd_sched.prepare(*t, 5 * NM, 1000 * FT, 300.0,
                          torch.full((n_tot, kk), -1, dtype=torch.int32),
                          block=BLOCK)
    outs = cd_sched.run_kernels(xs, p)
    slot = xs.perm.long()                    # each aircraft's padded slot
    merged = outs[11].transpose(0, 1).reshape(kk, n_tot)[:, slot].numpy()
    s64 = slab64(cols, "tas", cols[3])
    w = cd_pallas.row_block_plain(s64, s64, slot, slot,
                                  torch.full((kk, N), -1), p)
    assert _sets(merged, merged >= 0) == _sets(w[11].numpy(),
                                               w[11].numpy() >= 0)
