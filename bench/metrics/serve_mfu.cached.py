"""Cache-served images' share of the f32 peak, counted from shapes."""

from gsbench import readers


def read(ctx):
    return readers.serve_mfu(ctx)
