"""Device ms a four-card step in ``train.backward`` (rank 0)."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "train.backward", "train.step")
