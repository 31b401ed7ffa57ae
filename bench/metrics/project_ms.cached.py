"""Device ms a cache-served batch in the program's ``project`` spans."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "project", "serve.dispatch")
