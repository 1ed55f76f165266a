"""The port's in-chunk instruments (``obs/scanstats.py``,
``obs/fingerprint.py``) against the JAX package's, on the CPU.

* Fingerprint, bit for bit: ``_words`` of float32, float64, bool and
  integer arrays, NaN payloads and -0.0 included, ``fold`` of a stepped
  state in float32 and float64, ``combine`` and ``chain`` equal JAX's
  on the same numpy arrays.  Then the JAX package's own checks
  (``tests/test_sdc.py``) on the port: deterministic, moved by one
  flipped mantissa bit and by two swapped columns, invariant to
  re-chunking through ``chain``, and the stepped state unchanged by
  the flag.
* ScanStats: the fold oracle of ``tests/test_scanstats.py`` (one
  20-step pack equals ``reduce_packs`` of twenty 1-step packs, bit for
  bit, dense and sparse), and the port's pack against JAX's on the same
  dense scene: the int fields equal, ``headroom_min_m`` within 1e-2 m
  (the altitude tolerance of ``tests/test_torch_slice.py``) and
  ``min_sep_m`` within 3 m (positions agree within 1e-5 deg, 1.1 m, so
  a separation within 2.2 m).
"""
import bisect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import step as jstep
from bluesky_tpu.obs import fingerprint as jfp, scanstats as jss
from bluesky_tpu_torch.core import asas as tasas, step as tstep
from bluesky_tpu_torch.obs import fingerprint as tfp, scanstats as tss

from torch_parity import build_pair

NSTEPS = 20


def _nan_payloads(dtype):
    word = {np.float32: np.uint32, np.float64: np.uint64}[dtype]
    top = {np.float32: 0x7F800000, np.float64: 0x7FF0000000000000}[dtype]
    sign = {np.float32: 0x80000000, np.float64: 0x8000000000000000}[dtype]
    raw = np.array([top | 1, top | 0x12345, sign | top | 3, sign, 0, top],
                   dtype=word)
    return raw.view(dtype)              # NaNs, -0.0, 0.0, +inf


ARRAYS = {
    "float32": np.random.default_rng(0).standard_normal(37)
    .astype(np.float32),
    "float64": np.random.default_rng(1).standard_normal((5, 7)),
    "float32-nan-negzero": _nan_payloads(np.float32),
    "float64-nan-negzero": _nan_payloads(np.float64),
    "bool": np.random.default_rng(2).random(33) > 0.5,
    "int32": np.random.default_rng(3).integers(-2 ** 31, 2 ** 31, 29)
    .astype(np.int32),
    "int8": np.arange(-4, 4, dtype=np.int8),
    "float64-scalar": np.float64(-0.0),
}


@pytest.mark.parametrize("name", ARRAYS)
def test_words_match_jax(name):
    arr = ARRAYS[name]
    j = np.asarray(jfp._words(jnp.asarray(arr))).astype(np.uint64)
    t = tfp._words(torch.from_numpy(np.array(arr)))
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy().astype(np.uint64), j)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fold_matches_jax(dtype):
    """Two folds of a stepped state (a rotation and an XOR of every
    watched column) give JAX's words."""
    jstate, tstate = build_pair(32, 24, geom="cluster", dtype=dtype)
    cfg = tstep.SimConfig(cd_backend="tiled", cd_block=32)
    tstate = tstep.run_steps(tstate, cfg, 3)
    jstate = _jax_state(tstate, jstate)
    jcfg = jstep.SimConfig()
    jp = jfp.fold(jfp.fold(jfp.init(jstate, jcfg), jstate, jcfg),
                  jstate, jcfg)
    tp = tfp.fold(tfp.fold(tfp.init(tstate, cfg), tstate, cfg), tstate,
                  cfg)
    np.testing.assert_array_equal(tp.fp.numpy().astype(np.uint64),
                                  np.asarray(jp.fp).astype(np.uint64))
    assert int(tp.steps) == int(jp.steps) == 2
    assert tfp.combine(tp) == jfp.combine(jp) != 0


def _jax_state(tstate, like):
    """The port's ``tstate`` as a JAX state of the layout of ``like``."""
    from bluesky_tpu_torch.core.state import state_to_numpy
    tree = state_to_numpy(tstate)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(tree[jax.tree_util.keystr(p).lstrip(".")])
        for p, _ in leaves])


def test_combine_and_chain_match_jax():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2 ** 32, 5, dtype=np.uint64)
    jpack = jfp.FingerprintPack(fp=jnp.asarray(words.astype(np.uint32)),
                                steps=jnp.zeros((), jnp.int32))
    tpack = tfp.FingerprintPack(fp=torch.from_numpy(words.astype(np.int64)),
                                steps=torch.zeros((), dtype=torch.int32))
    assert tfp.combine(tpack) == jfp.combine(jpack)
    prev = 0
    for w in rng.integers(0, 2 ** 32, 40, dtype=np.uint64):
        assert tfp.chain(prev, int(w)) == jfp.chain(prev, int(w))
        prev = tfp.chain(prev, int(w))
    assert tfp.summarize(prev, 40, 800) == jfp.summarize(prev, 40, 800)


def _flip_bit(t, idx=0, bit=2):
    """A copy of float32 ``t`` with one mantissa bit of element ``idx``
    flipped (finite in, finite out)."""
    raw = t.clone().view(torch.int32)
    raw[idx] ^= 1 << bit
    return raw.view(torch.float32)


@pytest.fixture(scope="module")
def small():
    return build_pair(8, 6, geom="cluster", pair_matrix=True)[1]


def test_fold_deterministic_and_state_sensitive(small):
    cfg = tstep.SimConfig()
    word = lambda s: tfp.combine(tfp.fold(tfp.init(s, cfg), s, cfg))
    assert word(small) == word(small) != 0
    flipped = small.replace(ac=small.ac.replace(lat=_flip_bit(small.ac.lat)))
    assert bool(torch.isfinite(flipped.ac.lat).all())
    assert word(flipped) != word(small)
    swapped = small.replace(ac=small.ac.replace(lat=small.ac.lon,
                                                lon=small.ac.lat))
    assert word(swapped) != word(small)


def test_chunk_fold_off_parity_and_chunking_invariance(small):
    off = tstep.run_steps_edge(small, tstep.SimConfig(), 8)[0]
    cfg = tstep.SimConfig(fingerprint=True)
    on, _, big = tstep.run_steps_edge(small, cfg, 8)
    from bluesky_tpu_torch.core.state import state_to_numpy
    a, b = state_to_numpy(off), state_to_numpy(on)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert int(big.steps) == 8
    s, chainw = small, 0
    for _ in range(8):
        s, _, p = tstep.run_steps_edge(s, cfg, 1)
        chainw = tfp.chain(chainw, tfp.combine(p))
    assert chainw == tfp.combine(big)


def test_host_chain_and_summary():
    assert tfp.chain(0, 0xDEADBEEF) == 0xDEADBEEF
    assert tfp.chain(tfp.chain(0, 1), 2) != tfp.chain(tfp.chain(0, 2), 1)
    assert tfp.chain(0x80000000, 0) == 1
    assert tfp.summarize(0xBEEF, 3, 60) == {"fp": "0000beef", "chunks": 3,
                                            "steps": 60}


# ------------------------------------------------------------------ ScanStats

def _sanity(pack, nsteps=NSTEPS):
    assert int(pack.steps) == nsteps
    assert int(pack.conf_peak) > 0, "the scene must produce conflicts"
    assert int(np.sum(np.asarray(pack.conf_hist))) == nsteps
    assert int(np.sum(np.asarray(pack.los_hist))) == nsteps
    assert int(pack.conf_sum) <= nsteps * int(pack.conf_peak)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_fold_oracle(backend):
    """One 20-step chunk's pack == ``reduce_packs`` of twenty 1-step
    packs, field by field and bit for bit; the stepped states equal."""
    tstate = build_pair(32, 24, geom="cluster",
                        pair_matrix=backend == "dense")[1]
    cfg = tstep.SimConfig(cd_backend=backend, cd_block=32, scanstats=True)
    if backend == "sparse":
        tstate = tasas.refresh_spatial_sort(tstate, cfg.asas, block=32,
                                            impl="sparse")
    big_state, _, big = tstep.run_steps_edge(tstate, cfg, NSTEPS,
                                             checked=True)
    s, packs = tstate, []
    for _ in range(NSTEPS):
        s, _, p = tstep.run_steps_edge(s, cfg, 1, checked=True)
        packs.append(p)
    assert float(s.simt) == float(big_state.simt)
    assert torch.equal(s.ac.lat, big_state.ac.lat)
    small = tss.reduce_packs(packs)
    _sanity(big)
    for f in tss.ScanStats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(small, f)),
                                      getattr(big, f).numpy(), err_msg=f)
    assert np.isfinite(big.min_sep_m.numpy()).all()
    assert np.isfinite(big.headroom_min_m.numpy()).all()


def test_pack_matches_jax():
    jstate, tstate = build_pair(32, 24, geom="cluster", pair_matrix=True)
    _, _, jpack = jstep.run_steps_edge(
        jstate, jstep.SimConfig(scanstats=True), NSTEPS, checked=True)
    _, _, tpack = tstep.run_steps_edge(
        tstate, tstep.SimConfig(scanstats=True), NSTEPS, checked=True)
    _sanity(tpack)
    for f in tss.ScanStats._fields:
        t, j = getattr(tpack, f).numpy(), np.asarray(getattr(jpack, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f
        if f == "min_sep_m":
            np.testing.assert_allclose(t, j, rtol=0, atol=3.0, err_msg=f)
        elif f == "headroom_min_m":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-2, err_msg=f)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)


def test_summarize_merge_consistency(small):
    cfg = tstep.SimConfig(scanstats=True)
    s, packs = small, []
    for _ in range(4):
        s, _, p = tstep.run_steps_edge(s, cfg, 5, checked=True)
        packs.append(p)
    merged = tss.merge_summaries([tss.summarize(p) for p in packs])
    whole = tss.summarize(tss.reduce_packs(packs))
    assert merged["steps"] == whole["steps"] == 20
    for key in ("conf_peak", "los_peak", "min_sep_m",
                "alt_headroom_min_m", "occ_peak"):
        assert merged[key] == whole[key], key
    assert merged["conf_mean"] == pytest.approx(whole["conf_mean"],
                                                abs=2e-3)
    assert tss.summarize(packs[0]) == jss.summarize(packs[0])


def test_device_bucketing_matches_host_histogram():
    """The fold's bucket of a count is ``bisect_left`` of the bounds,
    the edges included."""
    bounds = list(tss.COUNT_BUCKETS)
    got = [int(tss._bucket(torch.tensor(v, dtype=torch.int32),
                           tss._bounds(torch.device("cpu"))))
           for v in range(0, 5200)]
    assert got == [bisect.bisect_left(bounds, float(v))
                   for v in range(0, 5200)]
