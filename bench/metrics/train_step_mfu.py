"""The training step's share of the card's float32 peak, from shapes."""

from gsbench import readers


def read(ctx):
    return readers.train_mfu(ctx)
