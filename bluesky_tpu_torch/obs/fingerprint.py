"""State fingerprint: a bit-pattern fold of the stepped state.

Port of ``bluesky_tpu/obs/fingerprint.py``.  Two executions of the same
chunk on healthy hardware give the same stepped state bit for bit, so a
cheap order-sensitive fold of the state's raw bit patterns is a witness
that can be compared across re-executions (and between the port and the
JAX package, on the same arrays: the fold equals JAX's bit for bit).

``FingerprintPack`` is folded once per step from the post-step state by
the chunk runner (``SimConfig.fingerprint``) and returned once per chunk
next to the telemetry.  Each step rotates the running word left by one
bit and XORs in the step word; each watched column (``GUARD_FIELDS`` and
the live mask) is rotated by its field index first, so time- and
field-transposed changes move the fingerprint.

torch has few operators on ``uint32``, so a 32-bit word is held in an
``int64`` in [0, 2**32): the 32-bit mask keeps every shift exact and
every right shift logical.  The XOR over the rows is taken bit by bit,
as the parity of each bit's count.  ``drain`` retires a pack into the
``obs/metrics.py`` registry.
"""
from typing import NamedTuple

import numpy as np
import torch

from .scanstats import n_partials

#: 32-bit mask of the word arithmetic
_M32 = 0xFFFFFFFF


class FingerprintPack(NamedTuple):
    """Per-chunk fingerprint accumulator: ``fp`` keeps ``[P]`` per-shard
    partial words (int64 holding uint32 values; P the shard count,
    ``n_partials``), ``steps`` counts the folds."""
    fp: torch.Tensor      # [P] int64 in [0, 2**32)
    steps: torch.Tensor   # [] int32


def _rotl(x, k: int):
    """Rotate 32-bit words (int64 in [0, 2**32)) left by a static k."""
    k %= 32
    if k == 0:
        return x
    return ((x << k) | (x >> (32 - k))) & _M32


def _words(x: torch.Tensor) -> torch.Tensor:
    """Any state leaf as 32-bit words (int64 in [0, 2**32)), shape
    preserving: bools widen, integers of at most 4 bytes wrap modulo
    2**32 (JAX's ``astype(uint32)``), 4-byte floats give their bit
    pattern, 8-byte leaves XOR their two words."""
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    if x.element_size() == 8:
        v = x.reshape(-1).view(torch.int32).reshape(*x.shape, 2)
        v = v.to(torch.int64) & _M32
        return v[..., 0] ^ v[..., 1]
    if not x.is_floating_point():
        return x.to(torch.int64) & _M32
    return x.view(torch.int32).to(torch.int64) & _M32


def _xor_rows(acc: torch.Tensor) -> torch.Tensor:
    """XOR of the words of each row of ``acc`` [..., P, M] -> [..., P]:
    each bit of the result is the parity of that bit's count over the
    row."""
    shift = torch.arange(32, device=acc.device)
    bits = (acc[..., None] >> shift) & 1                   # [P, M, 32]
    parity = bits.sum(-2) & 1                              # [P, 32]
    return (parity << shift).sum(-1)


def init(state, cfg) -> FingerprintPack:
    """Fresh fold for one chunk, on the state's device; a stacked state
    (``core/step.stack_worlds``) gets a pack per world, [W, P] and
    [W]."""
    dev = state.ac.active.device
    lead = tuple(state.ac.active.shape[:-1])
    p = n_partials(cfg, int(state.ac.active.shape[-1]))
    return FingerprintPack(fp=torch.zeros(lead + (p,), dtype=torch.int64,
                                          device=dev),
                           steps=torch.zeros(lead, dtype=torch.int32,
                                             device=dev))


def fold(pack: FingerprintPack, state, cfg) -> FingerprintPack:
    """One fold of the post-step state: ``fp' = rotl(fp, 1) XOR
    step_word``, the step word the XOR of the row split of every watched
    column, each column rotated by its field index first."""
    from ..core.step import GUARD_FIELDS
    p = pack.fp.shape[-1]
    ac = state.ac
    part = lambda x: x.reshape(*ac.active.shape[:-1], p, -1)
    acc = part(_words(ac.active))
    for i, f in enumerate(GUARD_FIELDS):
        acc = acc ^ _rotl(part(_words(getattr(ac, f))), i + 1)
    return FingerprintPack(fp=_rotl(pack.fp, 1) ^ _xor_rows(acc),
                           steps=pack.steps + 1)


# ------------------------------------------------------------------ host side

def combine(pack) -> int:
    """XOR a pack's [P] partials into one 32-bit int."""
    fp = pack.fp
    fp = fp.detach().cpu().numpy() if isinstance(fp, torch.Tensor) else fp
    fp = np.asarray(fp, dtype=np.uint64)
    return int(np.bitwise_xor.reduce(fp)) & _M32 if fp.size else 0


def chain(prev: int, chunk_fp: int) -> int:
    """Fold one chunk fingerprint into the running chain: the same
    rotate-XOR recurrence as the fold, so chunk order matters."""
    prev &= _M32
    return (((prev << 1) | (prev >> 31)) ^ chunk_fp) & _M32


def summarize(chain_fp: int, chunks: int, steps: int) -> dict:
    """The wire/heartbeat summary dict of a running chain."""
    return {"fp": format(chain_fp & _M32, "08x"),
            "chunks": int(chunks), "steps": int(steps)}


def drain(reg, pack) -> int:
    """Retire one chunk pack into a metrics ``Registry``
    (``obs/metrics.py``): returns the combined 32-bit chunk fingerprint
    and counts the fold cadence."""
    fp = combine(pack)
    steps = pack.steps
    steps = int(steps.item() if isinstance(steps, torch.Tensor)
                else np.asarray(steps))
    reg.counter("sim_fp_chunks",
                "Chunks retired with a state fingerprint fold").inc()
    reg.counter("sim_fp_steps",
                "Steps folded into state fingerprints").inc(steps)
    return fp
