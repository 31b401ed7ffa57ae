"""Share of the four-card training window with rank 0's card idle."""

from gsbench import readers


def read(ctx):
    return readers.idle_share(ctx)
