"""Milliseconds per traced call in the program's ``stardist.raster.astype``
spans: the host label image's conversion to int32."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "stardist.raster.astype") if ctx.ndim == 2 else None
