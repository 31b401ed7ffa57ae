"""The four-card step's share of the four cards' f32 peak, from shapes."""

from gsbench import readers


def read(ctx):
    return readers.train_mfu(ctx)
