"""The sort refresh (``core/asas.refresh_spatial_sort``): the median of
CUDA-event times of single calls on the window's state."""


def read(ctx):
    from bluesky_tpu_torch.core import asas
    cfg = ctx.sim.cfg
    if cfg.cd_backend not in ("sparse", "pallas", "tiled"):
        return None
    st = ctx.sim.traf.state
    impl = asas.impl_for_backend(cfg.cd_backend)
    fn = lambda: asas.refresh_spatial_sort(st, cfg.asas, block=cfg.cd_block,
                                           impl=impl)
    fn()
    return ctx.event_ms(fn, 12)
