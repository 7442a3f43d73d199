"""The device's idle time while the host is in the program's `fit.forward`
spans (or a span inside one), over the wall of the second traced stretch
(span_stretch.py), %."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.share(ctx, "idle_under", "fit.forward", "wall_s")
