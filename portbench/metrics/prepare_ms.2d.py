"""Milliseconds per traced call in the program's ``stardist.prepare`` spans:
the host's set-up of the input (axes, normalizer, padding)."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "stardist.prepare") if ctx.ndim == 2 else None
