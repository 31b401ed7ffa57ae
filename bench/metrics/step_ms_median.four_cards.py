"""Median host-clock time of a four-card fit_partitions step."""

from gsbench import readers


def read(ctx):
    return readers.step_ms_median(ctx)
