"""Input voxels (millions) of the window's completed calls over the window:
from the first call's start to the last call's end, stalls included."""


def read(ctx):
    return ctx.rate(ctx.input_size / 1e6)
