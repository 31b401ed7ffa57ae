"""Device ms a four-card step in ``train.forward`` (rank 0)."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "train.forward", "train.step")
