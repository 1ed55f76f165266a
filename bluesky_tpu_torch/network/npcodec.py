"""msgpack codec with numpy ndarray support (port of
``bluesky_tpu/network/npcodec.py``, wire-identical to it).

Arrays travel as a tagged map of ``{dtype, shape, data}`` with the raw
``tobytes()`` payload (no pickling, safe to decode from untrusted
peers).  Torch tensors are not encoded: senders convert them to numpy
first (``utils.asnumpy``), so the device-to-host copy happens once, at
the stream boundary, and a JAX peer decodes every frame.
"""
import msgpack
import numpy as np

_ND = "__nd__"


def _encode(obj):
    if isinstance(obj, np.ndarray):
        return {_ND: True, "t": obj.dtype.str, "s": list(obj.shape),
                "d": obj.tobytes()}
    if isinstance(obj, (np.generic,)):
        return obj.item()
    raise TypeError(f"cannot serialize {type(obj)}")


def _decode(obj):
    if isinstance(obj, dict) and obj.get(_ND):
        arr = np.frombuffer(obj["d"], dtype=np.dtype(obj["t"]))
        return arr.reshape(obj["s"])
    return obj


def packb(data) -> bytes:
    return msgpack.packb(data, default=_encode, use_bin_type=True)


def unpackb(raw: bytes):
    return msgpack.unpackb(raw, object_hook=_decode, raw=False,
                           strict_map_key=False)
