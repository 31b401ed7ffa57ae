"""Device ms a training step in the program's ``project`` spans."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "project", "train.step")
