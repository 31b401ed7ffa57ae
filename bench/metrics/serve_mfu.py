"""Served images' share of the card's float32 peak, counted from shapes."""

from gsbench import readers


def read(ctx):
    return readers.serve_mfu(ctx)
