"""Device ms a cache-served batch in the images' ``serve.readback``."""

from gsbench import program_spans


def read(ctx):
    return program_spans.device_ms_per(ctx, "serve.readback", "serve.dispatch")
