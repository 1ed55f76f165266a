"""The sort refresh (``core/asas.refresh_spatial_sort``): the device time
of the ``sort_refresh`` spans of the traced window
(``simbench/spans.py``), at the chunk edge or inside a chunk; the
median."""
from simbench import spans


def read(ctx):
    return spans.device_ms(ctx, "sort_refresh")
