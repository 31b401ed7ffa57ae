"""Device ms a served batch in the misses' ``serve.assign`` span."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "serve.assign", "serve.dispatch")
