"""Device-idle ms a training step while the host reads the loss back,
handles the overflow counters or slices the batch."""

from gsbench import program_spans


def read(ctx):
    return program_spans.sync_idle_ms(ctx)
