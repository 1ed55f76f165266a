"""The port's state against the JAX ``SimState``: a Traffic-built state
carried JAX -> numpy -> port -> numpy is bit-exact, and the port's
``make_state`` lays out the same fields, shapes, dtypes and padding
values as the JAX one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluesky_tpu.core import state as jstate_mod
from bluesky_tpu.core.traffic import Traffic as JTraffic
from bluesky_tpu_torch.core import state as tstate_mod
from bluesky_tpu_torch.core.state import state_from_numpy, state_to_numpy

from torch_parity import assert_trees_equal, jax_tree_to_numpy, scene


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_round_trip_is_bit_exact(dtype):
    lat, lon, hdg, alt, spd = scene(64, seed=5)
    jt = JTraffic(nmax=64, dtype=getattr(jnp, dtype), pair_matrix=False,
                  rng_seed=3)
    jt.create(64, "B744", alt, spd, None, lat, lon, hdg)
    jt.flush()
    tree = jax_tree_to_numpy(jt.state)
    st = state_from_numpy(tree, device="cpu")
    assert st.ac.lat.dtype == getattr(torch, dtype)
    assert st.simt.dtype == np.dtype(dtype)
    assert st.rng == 3                    # the PRNG key [0, 3] as its seed
    assert_trees_equal(state_to_numpy(st), tree)


@pytest.mark.parametrize("pair_matrix,k_partners", [(True, 8), (False, 8),
                                                    (False, 16)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_state_matches_jax(dtype, pair_matrix, k_partners):
    j = jax_tree_to_numpy(jstate_mod.make_state(
        40, 8, getattr(jnp, dtype), rng_seed=11, pair_matrix=pair_matrix,
        k_partners=k_partners))
    t = state_to_numpy(tstate_mod.make_state(
        40, 8, getattr(torch, dtype), rng_seed=11, pair_matrix=pair_matrix,
        k_partners=k_partners, device="cpu"))
    assert_trees_equal(t, j)
    assert t["asas.partners_s"].shape == (40 + tstate_mod.SORT_PAD,
                                          k_partners)
    assert t["asas.resopairs"].shape == ((40, 40) if pair_matrix else (0, 0))


def test_make_state_defaults_match_jax():
    """``make_state`` and ``Traffic`` default to the JAX package's
    ``pair_matrix=True`` and ``k_partners=8``."""
    import inspect
    from bluesky_tpu.core.traffic import Traffic as JT
    from bluesky_tpu_torch.core.traffic import Traffic as TT
    for jf, tf in ((jstate_mod.make_state, tstate_mod.make_state),
                   (JT.__init__, TT.__init__)):
        jp, tp = (inspect.signature(f).parameters for f in (jf, tf))
        for k in ("pair_matrix", "k_partners"):
            assert tp[k].default == jp[k].default, k
