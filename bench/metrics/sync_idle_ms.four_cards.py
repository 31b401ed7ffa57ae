"""Device-idle ms a four-card step in the host's readback, schedule and
batch spans (rank 0)."""

from gsbench import program_spans


def read(ctx):
    return program_spans.sync_idle_ms(ctx)
