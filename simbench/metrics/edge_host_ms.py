"""Host edge (``simulation/sim``): the window's wall time less the time
the host waited for chunk edges (the program's ``sim_edge_pull_ms``
series), per chunk: what the host loop itself costs a chunk."""


def read(ctx):
    w = ctx.window
    if not w["chunks"]:
        return None
    return (w["wall_s"] * 1e3 - w["edge_pull_ms"]) / w["chunks"]
