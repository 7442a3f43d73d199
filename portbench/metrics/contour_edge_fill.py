"""The share of the edges the raster prep sweeps that are contour edges,
%: the program's `raster.contour_edges` counter (contour edges over every
edge of every frame the prep's anchor sweep and tile overlap read) over
the second traced stretch (span_stretch.py)."""
from portbench import span_stretch


def read(ctx):
    s = span_stretch.of(ctx)
    hits, n = (s or {}).get("counters", {}).get("raster.contour_edges",
                                                (0, 0))
    return 100.0 * hits / n if n else None
