"""Host edge (``simulation/sim``): per chunk of the traced window
(``simbench/spans.py``), the union of the ``sync`` spans below its
``sim.step`` span: the host's blocking waits on the device a chunk, the
median."""
import statistics

from simbench import spans


def read(ctx):
    parts = spans.step_parts(ctx)
    if not parts:
        return None
    return statistics.median(w for _, w in parts) * 1e-3
