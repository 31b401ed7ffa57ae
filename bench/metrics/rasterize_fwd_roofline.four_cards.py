"""Forward compositor's share of its roofline, four-card training (rank 0)."""

from gsbench import readers


def read(ctx):
    return readers.roofline(ctx, "rasterize_fwd")
