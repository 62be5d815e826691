"""Mean ms per call of the forward stage (``details["timings_s"]["forward"]``, the
program's host clock between its own synchronizes) over the window's
untraced calls."""


def read(ctx):
    return ctx.stage_ms("forward") if ctx.ndim == 2 else None
