"""The benchmark of ``bluesky_tpu_torch``, the PyTorch and CUDA port:
one cell (a configuration under a traffic mix) a run, driven through the
embedded ``Simulation``; see ``README.md``."""
