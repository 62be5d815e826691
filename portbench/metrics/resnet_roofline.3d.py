"""The 3D ResNet forward's share (%) of its roofline, read as the same work
whatever implements it: the benchmark's FLOP count of one forward
(``flops.forward_flops``) times the completed calls of the window's traced
part, over the device seconds of the kernels that run inside the program's
``stardist.forward`` spans (copies and sets left out), over the bf16 peak.
The forward span ends in a sync, so every device event inside it is the
forward's. None for a U-Net, and where the trace holds no such span or no
kernel inside one."""
from portbench.frozen import PEAK_BF16
from portbench.spans import covered, merged

NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    if ctx.ndim != 3 or ctx.cfg.get("backbone") != "resnet" or ctx.trace is None:
        return None
    n = ctx.done(ctx.traced)
    spans = merged(ctx.trace, lambda x: x == "stardist.forward") if n else []
    if not spans:
        return None
    starts = [s for s, _ in spans]
    busy = sum(covered(spans, starts, s, e) for name, s, e in ctx.trace.device
               if not name.startswith(NOT_KERNELS))
    if busy <= 0:
        return None
    return 100.0 * ctx.flops_per_call * n / busy / PEAK_BF16
