"""bluesky_tpu_torch: the BlueSky ATC simulator on PyTorch and CUDA.

A port of ``bluesky_tpu`` (JAX/Pallas) for NVIDIA Hopper GPUs.  The
package mirrors the JAX layout (``core/``, ``ops/``, ``models/``) so
every module's counterpart is easy to find, imports nothing from JAX or
from ``bluesky_tpu``, and carries its own copies of the host-side
helpers it needs.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Without a CUDA device and without an explicit CPU
request they raise; they never fall back to the CPU on their own.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the
    caller's choice otherwise.  Raises when no CUDA device exists and the
    caller did not ask for another device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bluesky_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
