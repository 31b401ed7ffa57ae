"""Device ms a cold served batch in ``project`` spans (both projections)."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "project", "serve.dispatch")
