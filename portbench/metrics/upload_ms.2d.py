"""Milliseconds per traced call in the program's ``stardist.upload`` spans:
the input's copy to the card (none where the input is staged there)."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "stardist.upload") if ctx.ndim == 2 else None
