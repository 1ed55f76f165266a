"""Host edge (``simulation/sim``): per chunk of the traced window
(``simbench/spans.py``), the ``sim.step`` span less the ``sync`` spans
below it: the host's own work a chunk, the median."""
import statistics

from simbench import spans


def read(ctx):
    parts = spans.step_parts(ctx)
    if not parts:
        return None
    return statistics.median(d - w for d, w in parts) * 1e-3
