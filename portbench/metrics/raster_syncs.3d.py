"""CUDA sync events (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) per traced call inside the program's
``stardist.raster`` spans: the 3D raster's host syncs, most of them its
chunk loop's. None where the trace holds no device event (a run without a
card makes no CUDA sync); on the card 0 is a value."""
from portbench.spans import syncs_in


def read(ctx):
    if ctx.ndim != 3 or ctx.trace is None or not ctx.trace.device:
        return None
    got = syncs_in(ctx, "stardist.raster")
    return None if got is None else got[0]
