"""Shared arithmetic of the per-layer readers in ``metrics/``.

A reader takes the run's context (``ctx``: its kind, window seconds,
steps or requests, the step times, the server's counters, the program's
kernel launches recorded with their tile-table shapes, the device trace,
the cards the run used)
and returns a number, or None where it finds nothing to read.  Shares are
in percent; a share of the peak is of every card the run used.
"""

from __future__ import annotations

import statistics

from gsbench import counts


def roofline(ctx, kernel: str):
    """Counted least time of ``kernel``'s launches in the window over their
    device time, in percent; None without a trace or a launch."""
    if ctx.trace is None:
        return None
    bound = sum(counts.kernel_bound_s(name, T, K, F, th, tw)
                for name, T, K, F, th, tw in ctx.launches if name == kernel)
    spent = ctx.trace.seconds_matching(kernel + "_kernel")
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent


def idle_share(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def train_mfu(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    flops = counts.train_step_flops(**ctx.shapes) * ctx.steps
    return 100.0 * flops / (ctx.window_s * counts.PEAK_F32_FLOPS * ctx.cards)


def serve_mfu(ctx):
    if ctx.kind != "serve" or not ctx.requests:
        return None
    flops = counts.serve_request_flops(**ctx.shapes) * ctx.requests
    return 100.0 * flops / (ctx.window_s * counts.PEAK_F32_FLOPS * ctx.cards)


def hit_share(ctx):
    t = ctx.telemetry
    if not t or t.get("hits", 0) + t.get("misses", 0) == 0:
        return None
    return 100.0 * t["hits"] / (t["hits"] + t["misses"])


def step_ms_median(ctx):
    if not ctx.step_times:
        return None
    return 1e3 * statistics.median(ctx.step_times)


def nccl_share(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    s = ctx.trace.seconds_matching("nccl")
    return 100.0 * s / ctx.trace.window_s if s > 0 else None
