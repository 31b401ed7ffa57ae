"""Device time in NCCL kernels over the training window (rank 0)."""

from gsbench import readers


def read(ctx):
    return readers.nccl_share(ctx)
