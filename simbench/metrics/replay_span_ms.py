"""The replayed step (``core/step``, ``core/graph``): the device time of
each ``step.replay`` span of the traced window (``simbench/spans.py``),
a run of graph replays, over its ``steps``; the median, per step."""
import statistics

from simbench import spans


def read(ctx):
    per = [float(e["dur"]) / e["args"]["steps"]
           for e in spans.events(ctx)["device"]
           if e["name"] == "step.replay" and e["args"].get("steps")]
    return statistics.median(per) * 1e-3 if per else None
