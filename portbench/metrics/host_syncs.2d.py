"""Host syncs of one call after the window, as torch's sync debug mode
flags them (the frozen ``host_syncs``)."""


def read(ctx):
    return ctx.host_syncs if ctx.ndim == 2 else None
