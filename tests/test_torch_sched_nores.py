"""The port's sparse CD without a partner table
(``ops/cd_sched.detect_resolve_sched(partners=None)``, ROADMAP A10.1 and
B4: K1's no-resume form and K3 on the overflow rows, plain PyTorch on
the CPU) against the JAX function with its Pallas kernels in interpret
mode, in float32, MVP, on the cases of JAX's ``tests/test_cd_sched.py``:
five geometries, inactive aircraft and climbers, an all-inactive fleet,
a stale cached sort, the altitude-layered sort with a wider segment
budget, and the hand-off of a small fleet to the full grid.  Flags,
counts and partner sets are equal, the float reductions within rtol
1e-4 / atol 5e-3 (the f32 summation-order bound of JAX's file).

The host pieces are exact: the layered and ``"auto"`` destinations equal
JAX's integers, and the spatial and tiles modes and a world axis refuse
the form as JAX's does.  Sizes: N = 300 in blocks of 64 (more than two
blocks: the scheduled path), N = 100 for the hand-off; one jitted JAX
reference per segment cap.
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
JCFG = jmvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05, tlookahead=TLOOK)
TCFG = cr_mvp.MVPConfig(rpz_m=RPZ * 1.05, hpz_m=HPZ * 1.05,
                        tlookahead=TLOOK)


def make_args(n, geom, seed=0, act_frac=0.95, vs_spread=15.0):
    """JAX ``tests/test_cd_sched.make_args``'s columns as numpy float32
    and bool, the regional circle shrunk to the fleet (N = 300 in the
    3.8 deg circle has almost no conflicts); ``"clump"`` the circle of
    ``tests/test_torch_cd_sched.py`` in a 3 km altitude band, whose rows
    overflow one segment."""
    rng = np.random.default_rng(seed)
    if geom == "clump":
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 1.5 * np.sqrt(rng.random(n))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    elif geom == "regional":
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 1.2 * np.sqrt(rng.random(n))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    elif geom == "equator":
        lat = rng.uniform(-3.0, 3.0, n)
        lon = rng.uniform(-4.0, 6.0, n)
    elif geom == "antimeridian":
        lat = rng.uniform(-3.0, 3.0, n)
        lon = (rng.uniform(175.0, 185.0, n) + 180.0) % 360.0 - 180.0
    elif geom == "global":
        lat = np.degrees(np.arcsin(rng.uniform(-0.94, 0.94, n)))
        lon = rng.uniform(-180.0, 180.0, n)
    else:                       # continental
        lat = rng.uniform(45.0, 55.0, n)
        lon = rng.uniform(-5.0, 10.0, n)
    gs = rng.uniform(130.0, 240.0, n)
    trk = rng.uniform(0.0, 360.0, n)
    alt = rng.uniform(8000.0 if geom == "clump" else 3000.0, 11000.0, n)
    vs = rng.uniform(-vs_spread, vs_spread, n)
    active = rng.random(n) > (1.0 - act_frac)
    f = lambda a: np.asarray(a, np.float32)
    return [f(lat), f(lon), f(trk), f(gs), f(alt), f(vs),
            f(gs * np.sin(np.radians(trk))), f(gs * np.cos(np.radians(trk))),
            active, np.zeros(n, bool)]


@functools.lru_cache(maxsize=None)
def _jax_fn(s_cap):
    @jax.jit
    def run(cols, perm):
        return jsched.detect_resolve_sched(
            *cols, RPZ, HPZ, TLOOK, JCFG, block=BLOCK, s_cap=s_cap,
            interpret=True, perm=perm)
    return run


def jax_dest(cols, **kw):
    """JAX's stripe destinations of the columns (with their altitudes and
    vertical speeds, as the JAX function sorts when ``perm`` is None)."""
    J = jnp.asarray
    th = jsched.reach_threshold_m(J(cols[3]), J(cols[8]), TLOOK, RPZ)
    return np.asarray(jsched.stripe_sort_dest(
        J(cols[0]), J(cols[1]), J(cols[3]), J(cols[8]), th, BLOCK, 32,
        alt=J(cols[4]), vs=J(cols[5]), **kw))


def torch_dest(cols, **kw):
    T = torch.from_numpy
    th = cd_sched.reach_threshold_m(T(cols[3]), T(cols[8]), TLOOK, RPZ)
    return cd_sched.stripe_sort_dest(
        T(cols[0]), T(cols[1]), T(cols[3]), T(cols[8]), th, BLOCK, 32,
        alt=T(cols[4]), vs=T(cols[5]), **kw)


def run_jax(cols, perm, s_cap=6):
    rd = _jax_fn(s_cap)([jnp.asarray(a) for a in cols], jnp.asarray(perm))
    return jax.tree_util.tree_map(np.asarray, rd)


def run_torch(cols, perm=None, **kw):
    return cd_sched.detect_resolve_sched(
        *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, TCFG,
        block=BLOCK,
        perm=None if perm is None else torch.from_numpy(perm.copy()),
        **kw)


#: the float outputs by their index in ``cd_pallas.row_block_plain``
_FLOATS = {"tcpamax": 1, "sum_dve": 2, "sum_dvn": 3, "sum_dvv": 4,
           "tsolv": 5}


def assert_match(t, j, cols=None):
    """Flags, counts and partner sets equal, the floats within rtol 1e-4 /
    atol 5e-3 of JAX's.  With ``cols`` a float that misses is held to the
    float64 witness of its row (``slab64``): both packages within 5e-4 of
    it relative (module docstring of ``tests/test_torch_cd_pallas.py``: a
    single ill-conditioned MVP pair lifts the float32 rounding of its
    inputs by four orders).  Returns the rows that needed the witness."""
    for k in ("inconf", "nconf", "nlos"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), getattr(j, k),
                                      err_msg=k)
    assert partner_sets(t.topk_idx.numpy()) == partner_sets(j.topk_idx)
    witnessed, wit = set(), None
    for k, idx in _FLOATS.items():
        got, want = getattr(t, k).numpy(), getattr(j, k)
        miss = ~np.isclose(got, want, rtol=1e-4, atol=5e-3)
        if miss.any() and cols is not None:
            if wit is None:
                s = slab64(cols, "tas", cols[3])
                gid = torch.arange(s.shape[1])
                wit = cd_pallas.row_block_plain(
                    s, s, gid, gid, None,
                    cd_pallas.tile_params(RPZ, HPZ, TLOOK, TCFG))
            w = wit[idx].numpy()
            for r in np.flatnonzero(miss):
                assert abs(got[r] - w[r]) <= 5e-4 * abs(w[r]), (k, r)
                assert abs(want[r] - w[r]) <= 5e-4 * abs(w[r]), (k, r)
                witnessed.add(int(r))
            continue
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3,
                                   err_msg=k)
    return witnessed


@pytest.mark.parametrize("geom", ["continental", "regional", "equator",
                                  "antimeridian", "global"])
def test_parity_geometries(geom):
    """The default sort (``perm`` None in the port, JAX's destinations
    for JAX) on each geometry; the regional one also on the clump at
    ``s_cap=1``, where rows overflow, so that the overflow pass (K3 without
    a partner table) has rows."""
    cols = make_args(N, geom)
    dest = jax_dest(cols)
    np.testing.assert_array_equal(torch_dest(cols).numpy(), dest)
    j = run_jax(cols, dest)
    assert_match(run_torch(cols), j)
    if geom == "regional":
        assert int(j.nconf) > 0
        cols = make_args(N, "clump", vs_spread=8.0)
        dest = jax_dest(cols)
        x = cd_sched.prepare(*[torch.from_numpy(a) for a in cols], RPZ, HPZ,
                             TLOOK, None, block=BLOCK, s_cap=1,
                             perm=torch.from_numpy(dest.copy()))
        assert int(x.overflow.sum()) > 0      # the overflow pass has rows
        assert x.pold is None
        assert_match(run_torch(cols, dest, s_cap=1), run_jax(cols, dest, 1))


def test_parity_with_inactive_and_climbers():
    cols = make_args(N, "continental", seed=7, act_frac=0.7, vs_spread=16.0)
    dest = jax_dest(cols)
    j = run_jax(cols, dest)
    assert int(j.nconf) > 0
    assert_match(run_torch(cols, dest), j)


def test_all_inactive():
    cols = make_args(N, "continental", act_frac=0.0)
    out = run_torch(cols)
    assert int(out.nconf) == 0 and int(out.nlos) == 0
    assert not bool(out.inconf.any())
    assert bool((out.topk_idx == -1).all())
    assert_match(out, run_jax(cols, jax_dest(cols)))


def test_cached_stale_dest_is_exact():
    """A sort from old positions gives the result of a fresh one."""
    old = make_args(N, "regional", seed=1)
    new = make_args(N, "regional", seed=2)
    dest = jax_dest(old)
    j = run_jax(new, dest)
    assert int(j.nconf) > 0
    assert_match(run_torch(new, dest), j)
    fresh = run_torch(new)
    for k in ("inconf", "nconf", "nlos"):
        assert torch.equal(getattr(fresh, k), getattr(run_torch(new, dest),
                                                      k)), k


def test_layered_schedule_is_exact():
    """The altitude-layered sort (16 layers) with a wider segment budget:
    the destinations are JAX's and injective, the result JAX's."""
    cols = make_args(N, "regional", seed=7)
    dest = jax_dest(cols, n_layers=16)
    dt = torch_dest(cols, n_layers=16).numpy()
    np.testing.assert_array_equal(dt, dest)
    assert len(np.unique(dt)) == N
    assert (dt != jax_dest(cols)).any()        # the layering reorders
    j = run_jax(cols, dest, 12)
    assert int(j.nconf) > 0
    # ownship 225's east sum comes from one ill-conditioned pair (with
    # aircraft 174): JAX's float32 lands 1.8e-3 from the float64 witness,
    # the port's 1.5e-2 (ROADMAP C, "Known, and not faults")
    assert assert_match(run_torch(cols, dt, s_cap=12), j, cols) == {225}


@pytest.mark.parametrize("geom", ["continental", "regional"])
def test_auto_layer_gate(geom):
    """``n_layers="auto"``: the on-device density gate's layer count and
    the destinations equal JAX's, injective and inside the layout, on a
    sparse scene and on a dense one (1,500 aircraft in 0.3 deg: the gate
    opens there)."""
    if geom == "regional":
        rng = np.random.default_rng(3)
        cols = make_args(1500, "continental", seed=3)
        cols[0] = (52.0 + rng.uniform(0, 0.3, 1500)).astype(np.float32)
        cols[1] = (4.0 + rng.uniform(0, 0.3, 1500)).astype(np.float32)
    else:
        cols = make_args(1500, geom, seed=3)
    J, T = jnp.asarray, torch.from_numpy
    th_j = jsched.reach_threshold_m(J(cols[3]), J(cols[8]), TLOOK, RPZ)
    th_t = cd_sched.reach_threshold_m(T(cols[3]), T(cols[8]), TLOOK, RPZ)
    nl_j = int(jsched._auto_layers(J(cols[0]), J(cols[1]), J(cols[4]),
                                   J(cols[8]), th_j))
    nl_t = int(cd_sched._auto_layers(T(cols[0]), T(cols[1]), T(cols[4]),
                                     T(cols[8]), th_t))
    assert nl_t == nl_j
    assert (nl_t > 0) == (geom == "regional")
    dest = jax_dest(cols, n_layers="auto")
    dt = torch_dest(cols, n_layers="auto").numpy()
    np.testing.assert_array_equal(dt, dest)
    assert len(np.unique(dt)) == 1500 and dt.max() < 1500 + 32 * BLOCK


def test_layered_dest_per_world():
    """A leading world axis sorts each world on its own, layered too."""
    a, b = make_args(N, "regional", seed=1), make_args(N, "continental",
                                                       seed=2)
    T = lambda i: torch.stack([torch.from_numpy(a[i]),
                               torch.from_numpy(b[i])])
    th = cd_sched.reach_threshold_m(T(3), T(8), TLOOK, RPZ)
    for kw in (dict(n_layers=4), dict(n_layers="auto")):
        got = cd_sched.stripe_sort_dest(T(0), T(1), T(3), T(8), th, BLOCK, 32,
                                        alt=T(4), vs=T(5), **kw)
        for w, cols in enumerate((a, b)):
            assert torch.equal(got[w], torch_dest(cols, **kw)), kw


def test_tile_sort_dest_takes_alt_and_vs():
    cols = make_args(N, "continental", seed=5)
    J, T = jnp.asarray, torch.from_numpy
    th_j = jsched.reach_threshold_m(J(cols[3]), J(cols[8]), TLOOK, RPZ)
    th_t = cd_sched.reach_threshold_m(T(cols[3]), T(cols[8]), TLOOK, RPZ)
    want = np.asarray(jsched.tile_sort_dest(
        J(cols[0]), J(cols[1]), J(cols[3]), J(cols[8]), th_j, BLOCK, 32,
        (2, 2), alt=J(cols[4]), vs=J(cols[5])))
    got = cd_sched.tile_sort_dest(
        T(cols[0]), T(cols[1]), T(cols[3]), T(cols[8]), th_t, BLOCK, 32,
        (2, 2), alt=T(cols[4]), vs=T(cols[5]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_small_n_delegates():
    """At most two blocks: the hand-off to ``detect_resolve_pallas``."""
    cols = make_args(100, "regional", seed=3)
    J = lambda a: jnp.asarray(a)
    j = jax.tree_util.tree_map(np.asarray, jsched.detect_resolve_sched(
        *[J(a) for a in cols], RPZ, HPZ, TLOOK, JCFG, block=BLOCK,
        interpret=True))
    assert int(j.nconf) > 0
    t = run_torch(cols)
    want = cd_pallas.detect_resolve_pallas(
        *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, TCFG,
        block=BLOCK)
    for k in t._fields:
        assert torch.equal(getattr(t, k), getattr(want, k)), k
    assert_match(t, j)


@pytest.mark.parametrize("mode,msg", [
    ("spatial", "spatial shard mode requires the resume/partner-table"),
    ("tiles", "tiles shard mode requires the resume/partner-table")])
def test_modes_without_partners_raise(mode, msg):
    """JAX's refusals: the spatial and tiles modes need the partner table
    (past the hand-off size, as in JAX)."""
    cols = make_args(N, "continental")
    with pytest.raises(ValueError, match=msg):
        run_torch(cols, shard_mode=mode, tile_shape=(2, 2))
    with pytest.raises(ValueError, match=msg):
        jsched.detect_resolve_sched(
            *[jnp.asarray(a) for a in cols], RPZ, HPZ, TLOOK, JCFG,
            block=BLOCK, interpret=True, shard_mode=mode,
            tile_shape=(2, 2))


def test_world_axis_without_partners_raises():
    cols = make_args(N, "continental")
    stacked = [torch.from_numpy(np.stack([a, a])) for a in cols]
    with pytest.raises(ValueError, match="one world"):
        cd_sched.detect_resolve_sched(*stacked, RPZ, HPZ, TLOOK, TCFG,
                                      block=BLOCK)


def test_noresume_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors K1's no-resume wrapper returns its plain version's
    10 outputs (17 under Swarm) and counts no launch."""
    cols = [torch.from_numpy(a) for a in make_args(N, "regional")]
    p = cd_pallas.tile_params(RPZ, HPZ, TLOOK, TCFG)
    before = (dict(cd_sched.LAUNCHES), dict(cd_pallas.LAUNCHES))
    for reso, n_out in (("mvp", 10), ("swarm", 17)):
        x = cd_sched.prepare(*cols, RPZ, HPZ, TLOOK, None, block=BLOCK,
                             s_cap=2, reso=reso, kk=5)
        got = cd_sched.sched_tiles(x.packed, x.wst, x.wln, x.wmax, None, p,
                                   reso=reso, kk=5)
        want = cd_sched.sched_tiles_plain(x.packed, x.wst, x.wln, x.wmax,
                                          None, p, reso, kk=5)
        assert len(got) == n_out and got[8].shape[1] == 5
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (dict(cd_sched.LAUNCHES), dict(cd_pallas.LAUNCHES)) == before
    assert all(k in cd_sched.LAUNCHES for k in (
        cd_sched.NORESUME, "cd_sched_tiles_noresume_eby",
        "cd_sched_tiles_noresume_swarm/rows"))
