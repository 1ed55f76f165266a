"""The ASAS interval (``core/asas.update_tiled`` -> ``ops/cd_sched`` ->
the resolver -> resume-nav): the median of CUDA-event times of single
calls on the window's state."""


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
    return ctx.event_ms(fn, 12)
