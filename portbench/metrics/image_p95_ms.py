"""The 95th percentile of every request's latency in the window, failed
ones included, from the call to its output ready on the card."""


def read(ctx):
    return ctx.p95_ms()
