"""Shared helpers of the ``test_torch_*`` parity tests: moving a JAX
``SimState`` to numpy in the ``{dotted.path: array}`` layout the port's
``state_from_numpy`` reads, building the same scene in both packages
from numpy-seeded inputs, and comparing stepped states field by field.

The parity tests run on the CPU: JAX through its CPU backend (Pallas
kernels in interpret mode), the port with ``device="cpu"``, where each
kernel wrapper runs its plain PyTorch version.  JAX is imported only
where a helper needs it, so the GPU-only kernel tests can use this
module on a machine without JAX.
"""
import numpy as np

NM, FT = 1852.0, 0.3048


def jax_tree_to_numpy(state) -> dict:
    """``{dotted.path: np.ndarray}`` of every leaf of a JAX pytree."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        out[jax.tree_util.keystr(path).lstrip(".")] = np.asarray(leaf)
    return out


def scene(n, geom="box", seed=0):
    """Per-aircraft creation inputs (lat, lon, hdg, alt, cas) for ``n``
    aircraft, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    if geom == "clump":
        ang = rng.uniform(0, 2 * np.pi, n)
        r = 0.6 * np.sqrt(rng.random(n))
        lat = 52.6 + r * np.cos(ang)
        lon = 5.4 + r * np.sin(ang) / 0.6
    elif geom == "equator":
        lat = rng.uniform(-2.0, 2.0, n)
        lon = rng.uniform(-3.0, 3.0, n)
    elif geom == "cluster":                 # conflicts in the first step
        lat = rng.uniform(51.85, 52.15, n)
        lon = rng.uniform(3.8, 4.2, n)
    else:                                   # a few stripes wide
        lat = rng.uniform(50.0, 55.0, n)
        lon = rng.uniform(2.0, 8.0, n)
    hdg = rng.uniform(0.0, 360.0, n)
    alt = rng.uniform(9000.0, 10500.0, n)
    spd = rng.uniform(130.0, 240.0, n)
    return lat, lon, hdg, alt, spd


def build_pair(nmax, n, geom="box", seed=0, dtype="float32",
               pair_matrix=False):
    """The same scene created through the JAX ``Traffic`` and the port's
    ``Traffic`` (on the CPU), with the [N, N] ``resopairs`` of the dense
    backend if ``pair_matrix``.  Returns ``(jax_state, torch_state)``."""
    import jax.numpy as jnp
    import torch
    from bluesky_tpu.core.traffic import Traffic as JTraffic
    from bluesky_tpu_torch.core.traffic import Traffic as TTraffic
    lat, lon, hdg, alt, spd = scene(n, geom, seed)
    jt = JTraffic(nmax=nmax, dtype=getattr(jnp, dtype),
                  pair_matrix=pair_matrix)
    tt = TTraffic(nmax=nmax, dtype=getattr(torch, dtype),
                  pair_matrix=pair_matrix, device="cpu")
    for t in (jt, tt):
        t.create(n, "B744", alt, spd, None, lat, lon, hdg)
        t.flush()
    return jt.state, tt.state


def assert_trees_equal(a: dict, b: dict):
    """Bit-exact equality of two ``{path: array}`` dicts."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert x.shape == y.shape, (k, x.shape, y.shape)
        assert np.array_equal(x, y, equal_nan=True), k


def partner_sets(table):
    """Row-wise sets of the non-negative ids of a partner table."""
    return [frozenset(int(x) for x in row if x >= 0)
            for row in np.asarray(table)]


def slab64(cols, key, extra):
    """The ``cd_pallas`` slab fields of every aircraft of the CD columns
    ``cols`` (lat, lon, trk, gs, alt, vs, gseast, gsnorth, active,
    noreso), in float64 from the float32 inputs, with the ``tr`` row of
    ``key``: the cas column ``extra`` itself, or the tas/gs ratio of the
    tas column ``extra`` (``cd_pallas.tr_row`` in float64).  The float64
    witness of a kernel pass is ``cd_pallas.row_block_plain`` on it."""
    import torch
    from bluesky_tpu_torch.ops import cd_pallas, cd_tiled
    lat, lon, trk, gs, alt, vs, gse, gsn, act, noreso = (
        torch.from_numpy(np.asarray(a)).double() for a in cols)
    trkrad = torch.deg2rad(trk)
    ex = torch.from_numpy(np.asarray(extra)).double()
    f = cd_tiled.precompute_trig(lat, lon)
    f.update(u=gs * torch.sin(trkrad), v=gs * torch.cos(trkrad), alt=alt,
             vs=vs, gse=gse, gsn=gsn, trk=trk, active=act, noreso=noreso,
             tr=ex if key == "cas" else ex / torch.clamp_min(gs, 0.5))
    return torch.stack([f[k] for k in cd_pallas._FIELDS])
