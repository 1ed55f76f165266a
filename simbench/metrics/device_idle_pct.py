"""The device (one H100): the share of a ``torch.profiler`` window of
``run.TRACE_CHUNKS`` ``Simulation.step`` chunks in which no device operation
runs."""


def read(ctx):
    p = ctx.profile()
    if not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
