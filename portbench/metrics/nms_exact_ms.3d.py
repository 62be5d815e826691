"""Milliseconds per traced call in the program's ``stardist.nms.exact``
spans: the 3D NMS's exact lattice test, each span ended by a sync."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "stardist.nms.exact") if ctx.ndim == 3 else None
