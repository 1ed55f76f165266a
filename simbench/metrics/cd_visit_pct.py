"""The kernels (``csrc/cd_tiles.cu``): the pairs the CD work needs over
the pairs in the tiles the walker visits, in the last interval of the
traced window (``simbench/spans.py``): its counters ``cd_k1_tiles``
(the segment pass) and ``cd_k2_tiles`` (the overflow rows' pass) times
``cd_block`` squared, against the ordered pairs that
``simbench/reference/pairs.py`` finds on the window's final state, as
``cd_roofline`` counts them."""
import torch

from simbench import spans
from simbench.reference import pairs


def read(ctx):
    k1 = spans.last_counter(ctx, "cd.k1", "cd_k1_tiles")
    k2 = spans.last_counter(ctx, "cd.k2", "cd_k2_tiles")
    if k1 is None or k2 is None or k1 + k2 <= 0:
        return None
    cfg = ctx.sim.cfg
    ac = ctx.sim.traf.state.ac
    cols = {k: getattr(ac, k).double() for k in ("lat", "lon", "alt", "gs",
                                                 "vs")}
    need = pairs.count_needed(cols, ac.active, cfg.asas.rpz, cfg.asas.hpz,
                              cfg.asas.dtlookahead)
    block = min(cfg.cd_block, 256)
    visited = (k1 + k2) * block * block
    ctx.note(f"cd_visit_pct: {need} pairs needed, {k1} + {k2} tiles of "
             f"{block} x {block} visited")
    del cols
    torch.cuda.empty_cache()
    return 100.0 * need / visited
