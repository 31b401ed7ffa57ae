"""The backward compositor's share of its roofline in the training step."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "rasterize_bwd")
