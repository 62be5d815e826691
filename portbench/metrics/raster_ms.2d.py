"""Mean ms per call of the raster stage (``details["timings_s"]["raster"]``, the
program's host clock between its own synchronizes) over the window's
untraced calls."""


def read(ctx):
    return ctx.stage_ms("raster") if ctx.ndim == 2 else None
