"""The interactions layer's share of the device's busy time, %: the
device time of the operations that belong to the program's `interactions`
spans (the detached-scale MANO pass and the SDF grids, the SDF terms; with
their backward), over the busy time of the second traced stretch
(span_stretch.py)."""
from portbench import span_stretch


def read(ctx):
    return span_stretch.share(ctx, "under", "interactions", "busy_s")
