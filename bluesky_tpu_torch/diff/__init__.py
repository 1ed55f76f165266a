"""Differentiable simulation: gradients through the step.

Port of ``bluesky_tpu/diff/``, with ``torch.autograd`` in place of
``jax.value_and_grad`` and ``torch.utils.checkpoint`` in place of
``jax.checkpoint``:

* ``smooth``     the relaxations that make the dense step usefully
                 differentiable (``SmoothConfig`` on
                 ``SimConfig.smooth``; ``smooth=None``, the default
                 everywhere, is the serving step bit for bit);
* ``objectives`` soft (sigmoid) LoS count at an annealed temperature,
                 fuel burn, the waypoint-deviation penalty, and the hard
                 LoS count that verifies optimized plans;
* ``optimize``   Adam descent on per-aircraft lateral-waypoint and time
                 offsets through the chunked, checkpointed rollout, with
                 the integrity-guard word extended over the backward
                 pass and multi-start restarts on the world axis (the
                 OPT and GRAD stack commands,
                 ``Simulation.optimize_trajectories``).
"""
from .smooth import SmoothConfig                      # noqa: F401
from .objectives import ObjectiveWeights              # noqa: F401
