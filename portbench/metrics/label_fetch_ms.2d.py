"""Milliseconds per traced call in the program's ``stardist.raster.fetch``
spans: the label image's copy to the host (none where it stays on the card)."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "stardist.raster.fetch") if ctx.ndim == 2 else None
