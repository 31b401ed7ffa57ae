"""The forward compositor's share of its roofline in served dispatches."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "rasterize_fwd")
