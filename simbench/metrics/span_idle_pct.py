"""The device (one H100): the share of the traced window
(``simbench/spans.py``), from the first device span's start to the last
one's end, that no leaf device-timed span of the port covers."""
from simbench import spans


def read(ctx):
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in spans.device_leaves(ctx)]
    if not dev:
        return None
    w0, w1 = min(s for s, _ in dev), max(e for _, e in dev)
    if w1 <= w0:
        return None
    return 100.0 * (1.0 - spans.union(dev) / (w1 - w0))
