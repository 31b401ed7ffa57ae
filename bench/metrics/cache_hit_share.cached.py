"""The render server's pose-cache hits over its lookups in the window."""

from gsbench import readers


def read(ctx):
    return readers.hit_share(ctx)
