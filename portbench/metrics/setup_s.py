"""Seconds from the process's start to the window's first call."""


def read(ctx):
    return ctx.setup_s
