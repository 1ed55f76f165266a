"""The ASAS interval (``core/asas.update_tiled``): the device time of the
``asas.interval`` spans of the traced window (``simbench/spans.py``),
the intervals the window ran; the median."""
from simbench import spans


def read(ctx):
    return spans.device_ms(ctx, "asas.interval")
