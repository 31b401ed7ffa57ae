"""Device ms a training step in the program's ``train.backward`` span."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "train.backward", "train.step")
