"""MiB rank 0 receives a four-card step, its collectives' ``wire_bytes``."""

from gsbench import program_spans


def read(ctx):
    v = program_spans.counter_per(ctx, "wire_bytes", "train.step")
    return None if v is None else v / 2**20
