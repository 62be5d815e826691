"""Milliseconds per traced call in the program's ``stardist.raster.inside``
spans: per chunk of polyhedra of the 3D raster, the face geometry, the
inside test and the masked selection, whose nonzero is the chunk's sync,
so the host time holds the device time of the chunk's inside test."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "stardist.raster.inside") if ctx.ndim == 3 else None
