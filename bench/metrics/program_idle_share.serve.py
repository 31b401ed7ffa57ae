"""Share of the serving window with the device idle inside ``serve.*``
spans: the idle the render server causes."""

from gsbench import program_spans


def read(ctx):
    return program_spans.program_idle_share(ctx)
