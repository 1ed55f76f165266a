"""The host layout of the shard modes and their refreshes, the port
(``bluesky_tpu_torch``) against the JAX package on the same numpy-seeded
inputs: ``cd_sched.spatial_layout``, ``tile_offsets`` (1x2, 2x2, 4x2),
``tile_wire_blocks``, ``tile_sort_dest``, ``_tile_windows``,
``scatter_padded``'s sentinel drop, ``cd_pallas.interleave_rows`` (and
``split_rows`` over it), and ``core/asas.refresh_spatial_shard`` /
``refresh_tile_shard`` through ``parallel/sharding.prepare_spatial`` /
``prepare_tiles`` (new caller slots, sort, sorted-space partner table,
budgets and the stats).  Every int is bit-equal.  The overload refusals
are JAX's ``tests/test_spatial.py`` cases: a stripe or tile holding more
aircraft than its shard's caller rows raises ``RuntimeError`` in both
packages.  The JAX meshes are the conftest's virtual CPU devices; the
port's repeat the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core.asas import AsasConfig as JAsasConfig
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu.ops import cd_pallas as jpallas, cd_sched as jsched
from bluesky_tpu.parallel import sharding as jshard
from bluesky_tpu_torch.core.asas import AsasConfig
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
from bluesky_tpu_torch.ops import cd_pallas, cd_sched
from bluesky_tpu_torch.parallel import sharding

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,block,ndev", [(100, 256, 1), (1000, 256, 4),
                                          (100_000, 256, 4), (4000, 64, 8),
                                          (300, 64, 3), (50_000, 256, 34)])
def test_spatial_layout_and_table_size(n, block, ndev):
    assert cd_sched.spatial_layout(n, block, ndev) \
        == jsched.spatial_layout(n, block, ndev)


@pytest.mark.parametrize("tiles,nb_t,budgets", [
    ((1, 2), 10, ()), ((2, 2), 10, ()), ((4, 2), 10, ()),
    ((4, 2), 10, (3, 12, 4, 5, 6)), ((2, 2), 0, (7, 8, 9, 1, 2)),
    ((3, 3), 6, ())])
def test_tile_offsets_and_wire_blocks(tiles, nb_t, budgets):
    """The canonical offsets (4x2 dedupes the lon wrap to 5), their
    sender/receiver pairs, and the received halo blocks per tile."""
    offs = cd_sched.tile_offsets(tiles)
    assert offs == jsched.tile_offsets(tiles)
    if tiles == (4, 2):
        assert len(offs) == 5
    for off in offs:
        assert cd_sched._offset_pairs(tiles, off) \
            == jsched._offset_pairs(tiles, off)
    if budgets and len(budgets) != len(offs):
        budgets = budgets[:len(offs)]
    assert cd_sched.tile_wire_blocks(tiles, budgets, nb_t) \
        == jsched.tile_wire_blocks(tiles, budgets, nb_t)


@pytest.mark.parametrize("nb,ndev", [(36, 4), (37, 4), (40, 8), (5, 2)])
def test_interleave_rows(nb, ndev):
    """The row interleave equals JAX's, and ``split_rows`` hands shard d
    its part of it and puts every row's outputs back in place."""
    got = cd_pallas.interleave_rows(nb, ndev)
    want = jpallas.interleave_rows(nb, ndev)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    rows_l, _, rperm, _ = got
    seen = {}

    def run(d, rows, dev):
        seen[d] = rows.numpy()
        return [rows[:, None] * 10 + d]
    out = cd_pallas.split_rows(nb, [CPU] * ndev, CPU, run)[0]
    for d in range(ndev):
        part = rperm[d * rows_l:(d + 1) * rows_l]
        np.testing.assert_array_equal(seen.get(d, part[:0]),
                                      part[part < nb])
    np.testing.assert_array_equal(out[:, 0].numpy(),
                                  np.arange(nb) * 10 + np.arange(nb) % ndev)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_padded_sentinel(seed):
    """With ``sentinel`` a destination ``n_tot`` (an inactive row of the
    spatial and tiles layouts) is dropped, as JAX's scatter drops it;
    without, a destination past the layout raises."""
    rng = np.random.default_rng(seed)
    n, n_tot = 40, 64
    dest = rng.permutation(n_tot)[:n]
    dest[rng.random(n) < 0.3] = n_tot
    vals = rng.standard_normal(n).astype(np.float32)
    want = jsched.scatter_padded([jnp.asarray(vals)], jnp.asarray(dest),
                                 n_tot)[0]
    got = cd_sched.scatter_padded([torch.from_numpy(vals)],
                                  torch.from_numpy(dest), n_tot,
                                  sentinel=True)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(RuntimeError):
        cd_sched.scatter_padded([torch.from_numpy(vals)],
                                torch.from_numpy(dest), n_tot)


def _fleet(n, seed, geom="continental"):
    rng = np.random.default_rng(seed)
    if geom == "dot":
        lat, lon = rng.uniform(51.99, 52.01, n), rng.uniform(4.0, 4.1, n)
    else:
        lat, lon = rng.uniform(35.0, 60.0, n), rng.uniform(-10.0, 30.0, n)
    f = lambda a: np.asarray(a, np.float32)
    return dict(lat=f(lat), lon=f(lon), gs=f(rng.uniform(130, 240, n)),
                active=rng.random(n) > 0.1)


@pytest.mark.parametrize("tiles,seed", [((2, 2), 0), ((4, 2), 1),
                                        ((1, 2), 2), ((3, 1), 3)])
def test_tile_sort_dest_matches_jax(tiles, seed):
    n, block, extra = 3000, 64, 32
    c = _fleet(n, seed)
    thresh = np.float32(31_456.7)       # a float32 reach, as refreshed
    want = np.asarray(jax.jit(
        lambda lat, lon, gs, act, th: jsched.tile_sort_dest(
            lat, lon, gs, act, th, block, extra, tiles))(
        *(jnp.asarray(c[k]) for k in ("lat", "lon", "gs", "active")),
        jnp.asarray(thresh)))
    got = cd_sched.tile_sort_dest(
        *(torch.from_numpy(c[k]) for k in ("lat", "lon", "gs", "active")),
        torch.tensor(thresh), block, extra, tiles).numpy()
    np.testing.assert_array_equal(got[c["active"]], want[c["active"]])
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed,s_cap,overflow", [(0, 6, False),
                                                 (1, 6, True)])
def test_tile_windows_match_jax(seed, s_cap, overflow):
    """The present set ranked by global block id (invalid ``nb`` last),
    the gid table and the windows (JAX packs start | len << 20), with
    overflow rows given the synthetic full-present coverage."""
    rng = np.random.default_rng(seed)
    nb, rows, wmax = 40, 10, 4
    reach = rng.random((rows, nb)) < (0.6 if overflow else 0.12)
    gkey = np.concatenate([np.arange(10, 20),
                           np.where(rng.random(14) < 0.7,
                                    rng.integers(0, nb, 14), nb)])
    order_j, gid_j, wl_j = (np.asarray(a) for a in jsched._tile_windows(
        jnp.asarray(reach), jnp.asarray(gkey, jnp.int32), nb, s_cap, wmax))
    order, gid, st, ln = cd_sched._tile_windows(
        torch.from_numpy(reach), torch.from_numpy(gkey).long(), nb, s_cap,
        wmax)
    np.testing.assert_array_equal(order.numpy(), order_j)
    np.testing.assert_array_equal(gid.numpy(), gid_j)
    np.testing.assert_array_equal((st | (ln << 20)).numpy(), wl_j)
    if overflow:
        assert (ln.numpy().sum(1) == len(gkey)).any()


def _pair(n, nmax, seed, geom="continental"):
    """The same fleet in JAX's and the port's ``Traffic`` (float32, no
    pair matrix, the port on the CPU)."""
    rng = np.random.default_rng(seed)
    alt, spd = rng.uniform(9000, 9400, n), rng.uniform(130, 240, n)
    if geom == "dot":
        lat, lon = rng.uniform(51.99, 52.01, n), rng.uniform(4.0, 4.1, n)
    else:
        lat, lon = rng.uniform(35.0, 60.0, n), rng.uniform(-10.0, 30.0, n)
    hdg = rng.uniform(0, 360, n)
    jt = JTraffic(nmax=nmax, dtype=jnp.float32, pair_matrix=False)
    tt = TTraffic(nmax=nmax, dtype=torch.float32, pair_matrix=False,
                  device="cpu")
    for t in (jt, tt):
        t.create(n, "B744", alt, spd, None, lat, lon, hdg)
        t.flush()
    return jt.state, tt.state


def _assert_refresh(jout, tout, keys):
    (js, jnew, jinfo), (ts, tnew, tinfo) = jout, tout
    np.testing.assert_array_equal(tnew, np.asarray(jnew))
    np.testing.assert_array_equal(ts.asas.sort_perm.numpy(),
                                  np.asarray(js.asas.sort_perm))
    np.testing.assert_array_equal(ts.asas.partners_s.numpy(),
                                  np.asarray(js.asas.partners_s))
    np.testing.assert_array_equal(ts.ac.lat.numpy(), np.asarray(js.ac.lat))
    np.testing.assert_array_equal(ts.ac.active.numpy(),
                                  np.asarray(js.ac.active))
    np.testing.assert_array_equal(tinfo["counts"], np.asarray(jinfo["counts"]))
    for k in keys:
        assert tinfo[k] == jinfo[k], k
    assert tinfo["gsmax"] == pytest.approx(jinfo["gsmax"], rel=1e-6)


@pytest.mark.parametrize("ndev,halo,reso", [(4, 0, "MVP"), (2, 8, "MVP"),
                                            (4, 0, "SWARM")])
def test_refresh_spatial_shard_matches_jax(ndev, halo, reso):
    """``prepare_spatial`` (table sizing plus the spatial refresh) twice:
    entering the mode, then a refresh of the moved fleet (old sort and
    remapped partner table)."""
    js, ts = _pair(300, 512, 7)
    jcfg = JAsasConfig(reso_method=reso)
    tcfg = AsasConfig(reso_method=reso)
    jmesh = jshard.make_mesh(ndev)
    tmesh = sharding.make_mesh(ndev, devices=[CPU] * ndev)
    keys = ("occupancy", "halo_blocks", "halo_need", "nb", "nb_local",
            "n_tot", "extra_blocks", "halo_rows")
    jout = jshard.prepare_spatial(js, jmesh, jcfg, block=64,
                                  halo_blocks=halo, put=False)
    tout = sharding.prepare_spatial(ts, tmesh, tcfg, block=64,
                                    halo_blocks=halo)
    _assert_refresh(jout, tout, keys)
    # a partner table with entries, then the fleet moved 40 s on
    from bluesky_tpu.core import asas as jasas
    from bluesky_tpu_torch.core import asas as tasas
    rng = np.random.default_rng(3)
    table = rng.integers(-1, jout[2]["n_tot"], jout[0].asas.partners_s.shape)
    table = np.where(rng.random(table.shape) < 0.3, table, -1) \
        .astype(np.int32)

    def moved(state, xp, put):
        ac = state.ac
        return state.replace(
            ac=ac.replace(lat=ac.lat + ac.gsnorth * (40 / 111000.0),
                          lon=ac.lon + ac.gseast * (40 / 80000.0)),
            asas=state.asas.replace(partners_s=put(table)))
    js2 = moved(jout[0], jnp, jnp.asarray)
    ts2 = moved(tout[0], torch, torch.from_numpy)
    _assert_refresh(
        jasas.refresh_spatial_shard(js2, jcfg, ndev, block=64,
                                    halo_blocks=halo),
        tasas.refresh_spatial_shard(ts2, tcfg, ndev, block=64,
                                    halo_blocks=halo), keys)


@pytest.mark.parametrize("tiles,budgets", [((2, 2), ()), ((4, 2), ()),
                                           ((1, 2), (3,))])
def test_refresh_tile_shard_matches_jax(tiles, budgets):
    js, ts = _pair(300, 512, 11)
    jmesh = jshard.make_tile_mesh(tiles)
    tmesh = sharding.make_tile_mesh(tiles, devices=[CPU] * 8)
    jout = jshard.prepare_tiles(js, jmesh, JAsasConfig(), block=64,
                                budgets=budgets, put=False)
    tout = sharding.prepare_tiles(ts, tmesh, AsasConfig(), block=64,
                                  budgets=budgets)
    _assert_refresh(jout, tout, (
        "occupancy", "tile_shape", "offsets", "budgets", "needs", "nb",
        "nb_local", "n_tot", "extra_blocks", "halo_rows"))


def test_overloaded_stripe_and_tile_are_refused():
    """JAX ``tests/test_spatial.py`` ``test_spatial_refresh_rejects_
    overloaded_stripe`` and ``test_tiles_refresh_rejects_overloaded_tile``:
    600 aircraft in a dot, more than a shard's caller rows: both packages
    raise, naming the occupancy, and the port's message is JAX's."""
    for what in ("spatial", "tiles"):
        js, ts = _pair(600, 1024, 5, geom="dot")
        if what == "spatial":
            run_j = lambda: jshard.prepare_spatial(
                js, jshard.make_mesh(4), JAsasConfig(), block=256,
                put=False)
            run_t = lambda: sharding.prepare_spatial(
                ts, sharding.make_mesh(4, devices=[CPU] * 4), AsasConfig(),
                block=256)
        else:
            run_j = lambda: jshard.prepare_tiles(
                js, jshard.make_tile_mesh((4, 2)), JAsasConfig(),
                block=256, put=False)
            run_t = lambda: sharding.prepare_tiles(
                ts, sharding.make_tile_mesh((4, 2), devices=[CPU] * 8),
                AsasConfig(), block=256)
        with pytest.raises(RuntimeError, match="occupancy") as ej:
            run_j()
        with pytest.raises(RuntimeError, match="occupancy") as et:
            run_t()
        assert str(et.value) == str(ej.value)


def test_halo_past_its_pin_is_refused():
    """A pinned halo narrower than the drift-margin widened reach needs
    raises in both packages, with JAX's message."""
    js, ts = _pair(300, 512, 7)
    with pytest.raises(RuntimeError, match="halo coverage") as ej:
        jshard.prepare_spatial(js, jshard.make_mesh(2), JAsasConfig(),
                               block=64, halo_blocks=3, put=False)
    with pytest.raises(RuntimeError, match="halo coverage") as et:
        sharding.prepare_spatial(ts, sharding.make_mesh(2, devices=[CPU] * 2),
                                 AsasConfig(), block=64, halo_blocks=3)
    assert str(et.value) == str(ej.value)
