"""Median host-clock time of a fit_partitions step in the window."""

from gsbench import readers


def read(ctx):
    return readers.step_ms_median(ctx)
