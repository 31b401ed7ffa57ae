"""Share of the training window with nothing running on the device (rank 0)."""

from gsbench import readers


def read(ctx):
    return readers.idle_share(ctx)
