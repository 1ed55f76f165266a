"""The port's ``Traffic`` bookkeeping against the JAX package on the same
numpy-seeded scene: ``delete`` purging ``resopairs``, ``partners`` and
``partners_s`` (and a freed slot reused before the next interval),
``creconfs`` (position and speed of the synthetic intruder), ``id2idx``,
``reset``, ``apply_slot_permutation`` with its hooks, the create and
delete hooks, and the trails.

Everything is compared bit-exact but the ``creconfs`` projection, which
the port evaluates with torch's and JAX with XLA's sin/cos/atan2 (float64
rtol 1e-12, float32 rtol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu_torch.core.state import state_to_numpy
from bluesky_tpu_torch.core.traffic import Traffic as TTraffic

from torch_parity import assert_trees_equal, jax_tree_to_numpy, scene

NMAX, N, K = 64, 40, 8


def make_pair(dtype="float64", pair_matrix=True):
    lat, lon, hdg, alt, spd = scene(N, "clump", seed=6)
    jt = JTraffic(nmax=NMAX, dtype=getattr(jnp, dtype),
                  pair_matrix=pair_matrix, rng_seed=5)
    tt = TTraffic(nmax=NMAX, dtype=getattr(torch, dtype),
                  pair_matrix=pair_matrix, rng_seed=5, device="cpu")
    for t in (jt, tt):
        t.create(N, "B744", alt, spd, None, lat, lon, hdg)
        t.flush()
    return jt, tt


def trees(jt, tt):
    return jax_tree_to_numpy(jt.state), state_to_numpy(tt.state)


def fill_tables(jt, tt, seed=0):
    """The same random pair and partner tables (and sort) in both states,
    as ASAS intervals of the three kinds would leave them."""
    rng = np.random.default_rng(seed)
    act = np.asarray(jt.state.ac.active)
    rp = (rng.random((NMAX, NMAX)) < 0.2) & act[:, None] & act[None, :]
    part = np.where(rng.random((NMAX, K)) < 0.5,
                    rng.integers(0, N, (NMAX, K)), -1).astype(np.int32)
    ns = jt.state.asas.partners_s.shape[0]
    perm = rng.permutation(ns)[:NMAX].astype(np.int32)
    part_s = np.where(rng.random((ns, K)) < 0.3,
                      rng.choice(perm, (ns, K)), -1).astype(np.int32)
    vals = dict(resopairs=rp, partners=part, sort_perm=perm,
                partners_s=part_s)
    jt.state = jt.state.replace(asas=jt.state.asas.replace(
        **{k: jnp.asarray(v) for k, v in vals.items()}))
    ta = tt.state.asas
    for k, v in vals.items():
        getattr(ta, k).copy_(torch.from_numpy(v))
    return perm


def test_delete_purges_every_table_and_slot_reuse():
    jt, tt = make_pair()
    perm = fill_tables(jt, tt)
    jhits, thits = [], []
    jt.delete_hooks.append(jhits.append)
    tt.delete_hooks.append(thits.append)
    doomed = [3, 11, 12]
    for t in (jt, tt):
        assert t.delete(doomed)
        t.delete(30)
    assert jhits == thits == [doomed, [30]]
    j, t = trees(jt, tt)
    assert_trees_equal(t, j)
    gone = np.array(doomed + [30])
    assert not t["asas.resopairs"][gone].any()
    assert not t["asas.resopairs"][:, gone].any()
    assert not np.isin(t["asas.partners"], gone).any()
    assert not np.isin(t["asas.partners_s"], perm[gone]).any()
    assert (t["asas.partners"] >= 0).sum() > 0
    assert tt.ntraf == jt.ntraf == N - 4
    assert tt.ids == jt.ids and tt.id2idx(jt.ids[0]) == 0

    # a freed slot is reused by the next creation, before any interval,
    # and starts without pairs
    created = []
    tt.create_hooks.append(created.append)
    for t in (jt, tt):
        t.create(2, "A320", 3000.0, 150.0, None, [52.0, 52.1], [4.0, 4.1],
                 [90.0, 180.0], acid=None)
        t.flush()
    j, t = trees(jt, tt)
    assert_trees_equal(t, j)
    assert list(created[0]) == [3, 11]
    assert t["ac.active"][[3, 11]].all()
    assert not t["asas.resopairs"][[3, 11]].any()
    assert not np.isin(t["asas.partners"], [3, 11]).any()


def test_delete_without_pair_matrix():
    jt, tt = make_pair(pair_matrix=False)
    for t in (jt, tt):
        t.delete([0, 5])
    j, t = trees(jt, tt)
    assert_trees_equal(t, j)
    assert t["asas.resopairs"].shape == (0, 0)
    assert not t["ac.active"][[0, 5]].any()


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-6)])
def test_creconfs(dtype, rtol):
    jt, tt = make_pair(dtype)
    for t in (jt, tt):
        t.creconfs("CONF1", "B744", 7, 45.0, 0.5, 120.0)
        t.creconfs("CONF2", "A320", 9, -100.0, 1.5, 200.0, dh=600.0,
                   tlosv=90.0, spd=180.0)
    j, t = trees(jt, tt)
    slots = [tt.id2idx("CONF1"), tt.id2idx("CONF2")]
    assert slots == [jt.id2idx("CONF1"), jt.id2idx("CONF2")] == [N, N + 1]
    for k in j:
        if np.issubdtype(j[k].dtype, np.floating):
            np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=1e-9,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # the intruder flies the commanded geometry: CONF2 sits 600 m above
    # its target, descending towards it
    assert t["ac.alt"][N + 1] == pytest.approx(t["ac.alt"][9] + 600.0)
    assert t["ac.vs"][N + 1] < 0 and t["ac.selalt"][N + 1] == t["ac.alt"][9]


def test_id2idx_and_reset():
    jt, tt = make_pair()
    ids = [jt.ids[0], jt.ids[17].lower(), "NOPE"]
    assert tt.id2idx(ids) == jt.id2idx(ids) == [0, 17, -1]
    assert tt.id2idx("#") == jt.id2idx("*") == N - 1
    for t in (jt, tt):
        t.create(1, "B744", 3000.0, 150.0, None, 52.0, 4.0, 0.0, "PEND1")
    assert tt.id2idx("#") == jt.id2idx("#") == -2
    for t in (jt, tt):
        t.trails.setTrails(True)
        t.reset()
    assert tt.ntraf == jt.ntraf == 0
    assert tt.ids == jt.ids == [None] * NMAX
    assert not tt.trails.active and not jt.trails.active
    j, t = trees(jt, tt)
    assert_trees_equal(t, j)
    assert t["asas.resopairs"].shape == (NMAX, NMAX)


def test_slot_permutation_hooks_and_trails():
    jt, tt = make_pair()
    seen = []
    tt.permute_hooks.append(seen.append)
    for t in (jt, tt):
        t.trails.setTrails(True, 5.0)
        t.trails.update(0.0)                     # re-anchor
        t.trails.update(6.0, lat=np.asarray(t.state.ac.lat) + 0.01,
                        lon=np.asarray(t.state.ac.lon) - 0.02)
    newslot = np.random.default_rng(2).permutation(NMAX)
    for t in (jt, tt):
        t.apply_slot_permutation(newslot)
    assert len(seen) == 1 and np.array_equal(seen[0], newslot)
    assert tt.ids == jt.ids and tt.types == jt.types
    assert tt._id2slot == jt._id2slot
    assert tt.id2idx(jt.ids[newslot[4]]) == newslot[4]
    for k in ("lat0", "lon0", "lat1", "lon1", "time", "col", "newlat0",
              "accolor", "lastlat", "lastlon", "lasttim"):
        np.testing.assert_array_equal(getattr(tt.trails, k),
                                      getattr(jt.trails, k), err_msg=k)
    assert len(tt.trails.lat0) == N
    assert tt.trails.clear() == jt.trails.clear() == N
