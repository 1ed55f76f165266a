"""``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` with JAX's gradients.

The forward values are those of ``torch.clamp_min``, ``clamp_max`` and
``clamp``, bit for bit (NaN included).  The gradients differ at a tie:
JAX splits the cotangent of ``maximum(x, c)`` half and half when
``x == c`` (so ``jnp.clip`` passes 0.5 at a bound), while ``torch.clamp``
passes all of it.  ``torch.maximum`` and ``torch.minimum`` split as JAX
does, so the functions of the step that the differentiable rollout
(``diff/``) reaches clip through these.  A capture that lands exactly on
its target meets such a tie.
"""
import torch

#: the 0-d CPU tensors of the constant bounds, per (value, dtype): an
#: operand on the host, so an op on a CUDA tensor reads no device memory
#: for it and a CUDA graph captures it as an argument
_CONST = {}


def _bound(c, like: torch.Tensor):
    if isinstance(c, torch.Tensor):
        return c
    key = (float(c), like.dtype)
    t = _CONST.get(key)
    if t is None:
        t = _CONST[key] = torch.tensor(float(c), dtype=like.dtype)
    return t


def maximum(x: torch.Tensor, c) -> torch.Tensor:
    """``jnp.maximum(x, c)``: ``c`` a number or a tensor."""
    return torch.maximum(x, _bound(c, x))


def minimum(x: torch.Tensor, c) -> torch.Tensor:
    """``jnp.minimum(x, c)``."""
    return torch.minimum(x, _bound(c, x))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, i.e. ``minimum(maximum(x, lo), hi)``."""
    return minimum(maximum(x, lo), hi)
