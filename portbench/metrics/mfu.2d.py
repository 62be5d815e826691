"""The whole call's share (%) of the card's bf16 peak: the forward's FLOPs
(the benchmark's own count, ``flops.forward_flops``) times the window's
untraced completed calls, over their span, over 989 TFLOP/s."""
from portbench.frozen import PEAK_BF16


def read(ctx):
    if ctx.ndim != 2 or not ctx.calls or ctx.done(ctx.calls) == 0:
        return None
    return 100.0 * ctx.flops_per_call * ctx.done(ctx.calls) / ctx.span() / PEAK_BF16
