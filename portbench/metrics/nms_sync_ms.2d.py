"""Milliseconds per traced call that the host waits in CUDA sync events
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, ``cudaEventSynchronize``)
inside the program's ``stardist.nms`` spans."""
from portbench.spans import syncs_in


def read(ctx):
    got = syncs_in(ctx, "stardist.nms") if ctx.ndim == 2 else None
    return None if got is None else got[1]
