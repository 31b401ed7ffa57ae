"""The share of the cache-served window in which the device ran nothing."""

from gsbench import readers


def read(ctx):
    return readers.idle_share(ctx)
