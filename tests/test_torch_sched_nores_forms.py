"""The Eby and Swarm forms of the sparse CD without a partner table
(``cd_sched.detect_resolve_sched(partners=None, reso=...)``), its
replicate mode on a mesh, and the pallas pass in caller order
(``cd_pallas.detect_resolve_pallas(spatial_sort=False)``), on the CPU
against the JAX package's interpret-mode kernels.

* Eby and Swarm on the clump of ``test_torch_sched_nores.py`` at
  ``s_cap=1`` (overflow rows: both of the form's kernels run), and on a
  fleet of at most two blocks (the hand-off to ``detect_resolve_pallas``
  with the TAS, or the CAS, as JAX builds the column): flags, counts and
  partner sets equal; tcpamax, tsolv and the Swarm sums within rtol 1e-4
  / atol 5e-3 of JAX's; the Eby sums within that of the float64 witness,
  and JAX's within it of the port's wherever JAX's lies within it of the
  witness (``tests/test_torch_cd_pallas.py``: the port computes each Eby
  pair in float64, JAX in float32).
* The replicate mode without partners on a 3-shard CPU mesh is bit-equal
  to the single-device call, as JAX's row split is to its own.
* ``spatial_sort=False``: the full grid in caller order, against JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.ops import cd_pallas as jpallas, cd_sched as jsched
from bluesky_tpu_torch.ops import cd_pallas, cd_sched, cd_tiled
from bluesky_tpu_torch.parallel import sharding

from test_torch_sched_nores import (BLOCK, HPZ, JCFG, N, RPZ, TCFG, TLOOK,
                                    assert_match, jax_dest, make_args)
from torch_parity import partner_sets, slab64


def extra_col(cols, reso, seed=12):
    """The TAS (Eby, 0.9-1.1 x gs) or the CAS (Swarm, 0.6-0.8 x gs)."""
    rng = np.random.default_rng(seed)
    lo, hi = (0.9, 1.1) if reso == "eby" else (0.6, 0.8)
    return (cols[3] * rng.uniform(lo, hi, len(cols[3]))).astype(np.float32)


def reso_kw(reso, extra, to):
    return dict(reso=reso, tas=to(extra) if reso == "eby" else None,
                cas=to(extra) if reso == "swarm" else None)


@functools.lru_cache(maxsize=None)
def _jax_fn(reso, s_cap, small):
    @jax.jit
    def run(cols, perm, extra):
        return jsched.detect_resolve_sched(
            *cols, RPZ, HPZ, TLOOK, JCFG, block=BLOCK, s_cap=s_cap,
            interpret=True, perm=None if small else perm,
            **reso_kw(reso, extra, lambda a: a))
    return run


def run_both(cols, reso, s_cap=1):
    extra = extra_col(cols, reso)
    small = len(cols[0]) <= 2 * BLOCK
    perm = jax_dest(cols)
    j = jax.tree_util.tree_map(np.asarray, _jax_fn(reso, s_cap, small)(
        [jnp.asarray(a) for a in cols], jnp.asarray(perm),
        jnp.asarray(extra)))
    t = cd_sched.detect_resolve_sched(
        *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, TCFG,
        block=BLOCK, s_cap=s_cap, **reso_kw(reso, extra, torch.from_numpy))
    return t, j, extra


def assert_form(t, j, cols, reso, extra):
    (trd, tsw), (jrd, jsw) = (t, j) if reso == "swarm" else ((t, ()),
                                                            (j, ()))
    for k in ("inconf", "nconf", "nlos"):
        np.testing.assert_array_equal(getattr(trd, k).numpy(),
                                      getattr(jrd, k), err_msg=k)
    assert partner_sets(trd.topk_idx.numpy()) == partner_sets(jrd.topk_idx)
    sums = ("sum_dve", "sum_dvn", "sum_dvv")
    for k in ("tcpamax", "tsolv") + (sums if reso == "swarm" else ()):
        np.testing.assert_allclose(getattr(trd, k).numpy(), getattr(jrd, k),
                                   rtol=1e-4, atol=5e-3, err_msg=k)
    for name, a, b in zip(cd_pallas.SWARM_SUMS, tsw, jsw):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=5e-3,
                                   err_msg=name)
    if reso == "eby":
        s = slab64(cols, "tas", extra)
        gid = torch.arange(len(cols[0]))
        w = cd_pallas.row_block_plain(
            s, s, gid, gid, None,
            cd_pallas.tile_params(RPZ, HPZ, TLOOK, TCFG), "eby")
        close = lambda a, b: np.isclose(a, b, rtol=1e-4, atol=5e-3)
        for k, idx in zip(sums, (2, 3, 4)):
            got, want, wit = getattr(trd, k).numpy(), getattr(jrd, k), \
                w[idx].numpy()
            np.testing.assert_allclose(got, wit, rtol=1e-4, atol=5e-3,
                                       err_msg=f"{k} against float64")
            assert (close(got, want) | ~close(want, wit)).all(), k


@pytest.mark.parametrize("reso", ["eby", "swarm"])
def test_resolver_forms_match_jax(reso):
    cols = make_args(N, "clump", vs_spread=8.0)
    x = cd_sched.prepare(*[torch.from_numpy(a) for a in cols], RPZ, HPZ,
                         TLOOK, None, block=BLOCK, s_cap=1, reso=reso)
    assert int(x.overflow.sum()) > 0
    t, j, extra = run_both(cols, reso)
    assert int((t[0] if reso == "swarm" else t).nconf) > 0
    if reso == "swarm":
        assert float(t[1][0].sum()) > 0        # neighbours were found
    assert_form(t, j, cols, reso, extra)


@pytest.mark.parametrize("reso", ["eby", "swarm"])
def test_small_fleet_hands_off_in_each_form(reso):
    """At most two blocks: ``detect_resolve_pallas`` with the resolver
    column (Swarm's CAS; JAX's ground speed when none is given)."""
    cols = make_args(100, "clump", seed=3, vs_spread=8.0)
    t, j, extra = run_both(cols, reso)
    assert_form(t, j, cols, reso, extra)
    key = "tas" if reso == "eby" else "cas"
    want = cd_pallas.detect_resolve_pallas(
        *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, TCFG,
        block=BLOCK, reso=reso, extra_cols={key: torch.from_numpy(extra)})
    got = t
    if reso == "swarm":
        (got, sw), (want, sw_w) = t, want
        assert all(torch.equal(a, b) for a, b in zip(sw, sw_w))
        # without a CAS, Swarm's column is the ground speed
        nocas = cd_sched.detect_resolve_sched(
            *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, TCFG,
            block=BLOCK, reso="swarm")
        gs = cd_pallas.detect_resolve_pallas(
            *[torch.from_numpy(a) for a in cols], RPZ, HPZ, TLOOK, TCFG,
            block=BLOCK, reso="swarm",
            extra_cols={"cas": torch.from_numpy(cols[3])})
        assert all(torch.equal(a, b) for a, b in zip(nocas[1], gs[1]))
    for k in got._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("reso", ["mvp", "swarm"])
def test_replicate_mesh_without_partners_is_bit_equal(reso):
    """The replicate row split (3 CPU shards, the row-subset form of both
    kernels) gives the single-device call's bits."""
    cols = [torch.from_numpy(a)
            for a in make_args(N, "clump", vs_spread=8.0)]
    extra = torch.from_numpy(extra_col([a.numpy() for a in cols], "swarm"))
    kw = dict(block=BLOCK, s_cap=1, reso=reso,
              cas=extra if reso == "swarm" else None)
    ref = cd_sched.detect_resolve_sched(*cols, RPZ, HPZ, TLOOK, TCFG, **kw)
    mesh = sharding.make_mesh(3, devices=[torch.device("cpu")] * 3)
    got = cd_sched.detect_resolve_sched(*cols, RPZ, HPZ, TLOOK, TCFG,
                                        mesh=mesh, **kw)
    if reso == "swarm":
        (ref, sw_r), (got, sw_g) = ref, got
        assert all(torch.equal(a, b) for a, b in zip(sw_g, sw_r))
    assert int(ref.nconf) > 0
    for k in ref._fields:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


def test_pallas_in_caller_order_matches_jax():
    """``spatial_sort=False``: the pass in caller order (no Morton sort,
    a cached ``perm`` unread), against JAX's; the reachable tiles are
    more than the sorted pass's."""
    cols = make_args(N, "continental", seed=7)
    j = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda c: jpallas.detect_resolve_pallas(
            *c, RPZ, HPZ, TLOOK, JCFG, block=BLOCK, interpret=True,
            spatial_sort=False))([jnp.asarray(a) for a in cols]))
    T = [torch.from_numpy(a) for a in cols]
    t = cd_pallas.detect_resolve_pallas(
        *T, RPZ, HPZ, TLOOK, TCFG, block=BLOCK, spatial_sort=False,
        perm=torch.arange(N - 1, -1, -1))
    assert int(j.nconf) > 0
    assert_match(t, j, cols)
    sorted_rd = cd_pallas.detect_resolve_pallas(*T, RPZ, HPZ, TLOOK, TCFG,
                                                block=BLOCK)
    for k in ("inconf", "nconf", "nlos"):
        assert torch.equal(getattr(t, k), getattr(sorted_rd, k)), k
    morton = cd_tiled.spatial_permutation(T[0], T[1], T[8]).long()
    unsorted = cd_pallas.prepare(*T, RPZ, TLOOK, block=BLOCK)
    ordered = cd_pallas.prepare(*[a[morton] for a in T], RPZ, TLOOK,
                                block=BLOCK)
    assert int(unsorted.reach.sum()) > int(ordered.reach.sum())
