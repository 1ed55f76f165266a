"""Cross-cutting utilities: data logging, area filters, plotting."""
import numpy as np
import torch


def asnumpy(x):
    """A host NumPy array of ``x``: a tensor on any device (one copy from
    the card; on the CPU it shares memory) or anything ``np.asarray``
    takes."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
