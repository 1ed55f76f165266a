"""The kernels of one ASAS interval (``csrc/cd_tiles.cu`` and the
interval's other device operations) against the least time the card
could take: the larger of the operation and the byte bound of the work
the inputs need (``simbench/reference/roofline.py``, the pairs of
``simbench/reference/pairs.py`` counted on the window's state), over
the summed device time of every operation of one profiled call."""
import torch

from simbench.reference import pairs, roofline


def read(ctx):
    from bluesky_tpu_torch.core import asas
    cfg = ctx.sim.cfg
    if cfg.cd_backend == "dense":
        return None
    st = ctx.sim.traf.state
    impl = asas.impl_for_backend(cfg.cd_backend)
    fn = lambda: asas.update_tiled(st, cfg.asas, block=cfg.cd_block,
                                   impl=impl)
    fn()
    device_s = ctx.profile_call(fn).get("device_s")
    if not device_s:
        return None
    ac = st.ac
    cols = {k: getattr(ac, k).double() for k in ("lat", "lon", "alt", "gs",
                                                 "vs")}
    n = int(ac.active.sum())
    need = pairs.count_needed(cols, ac.active, cfg.asas.rpz, cfg.asas.hpz,
                              cfg.asas.dtlookahead)
    least, bound = roofline.least_seconds(need, n, st.asas.partners.shape[1])
    ctx.note(f"cd_roofline: {need} pairs needed, {n} aircraft, least "
             f"{least * 1e3:.6g} ms ({bound}), device {device_s * 1e3:.6g} "
             f"ms in one interval")
    del cols
    torch.cuda.empty_cache()
    return 100.0 * least / device_s
