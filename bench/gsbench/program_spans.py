"""Shared arithmetic of the readers of the program's own spans and counters.

The program (``repro_torch.runtime.spans``) records spans and counters
while a ``torch.profiler`` session is active, so a traced run's window
holds them; its host times are on the device trace's clock
(``time.time_ns``).  Everything here is clipped to the window
``[ctx.trace.t0, ctx.trace.t1]``: a span or a counter belongs to it when
it starts inside it, and host intervals and idle gaps are cut at its
edges.  "A step" is a window's ``train.step`` span, "a batch" its
``serve.dispatch`` span.  A span's device milliseconds are the time
between its two device marks (``Span.device_ms``), device idle inside it
included.

Every reader returns None without a trace, without the program's
recorder (a program that has none) or without the spans it reads.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def recorded() -> Optional[list]:
    """The program's records (spans and counters), or None where the
    program has no recorder."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.records()


def _window(ctx) -> Optional[Tuple[int, int]]:
    tr = ctx.trace
    if tr is None or tr.t1 <= tr.t0:
        return None
    return tr.t0, tr.t1


def _in_window(ctx):
    """-> (records starting in the window, every record, (t0, t1)), or
    None."""
    win, recs = _window(ctx), recorded()
    if win is None or not recs:
        return None
    t0, t1 = win
    return [r for r in recs if t0 <= r.t0_ns <= t1], recs, win


def _spans(recs, name: str) -> list:
    return [r for r in recs if hasattr(r, "t1_ns") and r.name == name]


def device_ms_per(ctx, name: str, unit: str) -> Optional[float]:
    """Device ms in the window's ``name`` spans over its ``unit`` spans."""
    got = _in_window(ctx)
    if got is None:
        return None
    recs = got[0]
    n = len(_spans(recs, unit))
    ms = [s.device_ms() for s in _spans(recs, name)]
    if n == 0 or not ms or any(m is None for m in ms):
        return None
    return sum(ms) / n


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_gaps(ctx) -> List[Tuple[int, int]]:
    """The window's stretches with nothing on the device (ns)."""
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    out, reach = [], t0
    for a, b in _union([(a, b) for a, b, _ in ctx.trace.intervals]):
        if a > reach:
            out.append((reach, min(a, t1)))
        reach = max(reach, b)
        if reach >= t1:
            break
    if reach < t1:
        out.append((reach, t1))
    return [(a, b) for a, b in out if b > a]


def _overlap_ns(xs, ys) -> int:
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(ctx, keep) -> Optional[Tuple[int, list]]:
    """-> (device-idle ns of the window while the host was inside a span
    ``keep(name)`` accepts, the window's records), or None without such a
    span."""
    got = _in_window(ctx)
    if got is None:
        return None
    recs, every, (t0, t1) = got
    # the host intervals of every such span that overlaps the window (one
    # still open runs to its end)
    host = [(max(r.t0_ns, t0), min(r.t1_ns or t1, t1)) for r in every
            if hasattr(r, "t1_ns") and keep(r.name) and r.t0_ns <= t1
            and (r.t1_ns or t1) >= t0]
    if not host:
        return None
    return _overlap_ns(_union(host), idle_gaps(ctx)), recs


def sync_idle_ms(ctx) -> Optional[float]:
    """Device-idle ms a step while the host reads the loss back, handles
    the step's overflow counters or slices the next batch."""
    got = idle_under(ctx, lambda n: n in ("train.readback", "train.schedule",
                                          "train.batch"))
    if got is None:
        return None
    ns, recs = got
    steps = len(_spans(recs, "train.step"))
    return ns / 1e6 / steps if steps else None


def program_idle_share(ctx) -> Optional[float]:
    """The share of the window, in percent, with the device idle while the
    host was inside one of the render server's spans."""
    got = idle_under(ctx, lambda n: n.startswith("serve."))
    if got is None:
        return None
    ns, _ = got
    return 100.0 * ns / (ctx.trace.t1 - ctx.trace.t0)


def counter_per(ctx, name: str, unit: str) -> Optional[float]:
    """The sum of counter ``name`` in the window over its ``unit`` spans."""
    got = _in_window(ctx)
    if got is None:
        return None
    recs = got[0]
    vals = [r.value for r in recs if not hasattr(r, "t1_ns")
            and r.name == name]
    n = len(_spans(recs, unit))
    if not vals or n == 0:
        return None
    return sum(vals) / n
