"""The conv kernel's share (%) of its roofline: the frozen ``conv_bound``
of every 3^nd conv of the forward at the cell's shape, times the completed
calls of the window's traced part, over the device time of the trace's
``conv_kernel`` events. None where the trace holds no such event."""
from portbench.frozen import conv_bound


def read(ctx):
    if ctx.ndim != 3 or ctx.trace is None:
        return None
    busy = ctx.trace.kernel_s("conv_kernel")
    if busy <= 0:
        return None
    bound_ms = sum(conv_bound(shape, cout)[0] for shape, cout, taps in ctx.conv_layers
                   if taps > 1)
    return 100.0 * bound_ms * 1e-3 * ctx.done(ctx.traced) / busy
