"""Mean ms per call of the nms stage (``details["timings_s"]["nms"]``, the
program's host clock between its own synchronizes) over the window's
untraced calls."""


def read(ctx):
    return ctx.stage_ms("nms") if ctx.ndim == 3 else None
