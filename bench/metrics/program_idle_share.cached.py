"""Share of the cache-served window with the device idle inside
``serve.*`` spans."""

from gsbench import program_spans


def read(ctx):
    return program_spans.program_idle_share(ctx)
