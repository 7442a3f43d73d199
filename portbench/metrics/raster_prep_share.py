"""The raster prep's share of the device's busy time, %: the device time
of the operations that belong to the program's `raster.prep` spans
(launched inside one, or by the backward of an op run inside one), over
the busy time of the second traced stretch (span_stretch.py)."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.share(ctx, "under", "raster.prep", "busy_s")
