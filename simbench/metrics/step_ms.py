"""The replayed step without CD (``core/step`` + ``core/graph``): CUDA
events around a run of replays of the plain gate pattern's captured
step on the window's state, per step."""


def read(ctx):
    from bluesky_tpu_torch.core import graph
    cfg = ctx.sim.cfg
    for key, ex in list(graph._CHUNKS.items()):
        if key[0] == cfg and not key[2] and False in ex.replays:
            return ctx.event_ms(ex.replays[False], 50, sync_each=False)
    return None
