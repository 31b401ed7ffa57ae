"""What a run records besides its end-to-end numbers: the harness's own
spans round its calls into the program (host clock, in memory), and with
``--trace 1`` the device's activity from ``torch.profiler`` (CUPTI) over
the window.

``DeviceTrace`` keeps every device interval (kernels, copies, sets) with
its name and reduces them to: the time the device was busy (the union of
the intervals), device time by name, and the idle gaps between intervals,
each named by the harness span the host was in at the gap's middle.  Both
clocks are the wall clock in nanoseconds (``time.time_ns``), the base the
profiler's events carry.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    """Named host intervals, in memory: (name, start ns, end ns)."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def at(self, t_ns: int) -> str:
        """The innermost span holding ``t_ns`` ("harness": the harness's
        own code between its calls into the program)."""
        best, width = "harness", None
        for name, a, b in self.items:
            if a <= t_ns <= b and (width is None or b - a < width):
                best, width = name, b - a
        return best


class DeviceTrace:
    """``torch.profiler`` over a block, device activity only; inactive
    (records nothing) when ``enabled`` is false."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.intervals: List[Tuple[int, int, str]] = []
        self.t0 = self.t1 = 0
        self._prof = None

    def __enter__(self):
        if self.enabled:
            act = torch.profiler.ProfilerActivity
            self._prof = torch.profiler.profile(activities=[act.CUDA])
            self._prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                self.intervals.append((e.start_ns(), e.end_ns(), e.name()))
        self.intervals.sort()
        self._prof = None
        return False

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        busy, reach = 0, None
        for a, b, _ in self.intervals:
            if reach is None or a > reach:
                busy += b - a
                reach = b
            elif b > reach:
                busy += b - reach
                reach = b
        return busy / 1e9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for a, b, name in self.intervals:
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def seconds_matching(self, *needles: str) -> float:
        """Device seconds of intervals whose name holds any needle (case
        ignored)."""
        low = [n.lower() for n in needles]
        return sum((b - a) / 1e9 for a, b, name in self.intervals
                   if any(n in name.lower() for n in low))

    def gaps(self, spans: Optional[Spans] = None) -> List[Tuple[str, float]]:
        """Idle gaps inside the window, longest first, each named by the
        host span at its middle."""
        out, reach = [], self.t0
        for a, b, _ in self.intervals:
            if a > reach:
                mid = (a + reach) // 2
                out.append((spans.at(mid) if spans else "harness",
                            (a - reach) / 1e9))
            reach = max(reach, b)
        if self.t1 > reach:
            out.append((spans.at((self.t1 + reach) // 2) if spans else
                        "harness", (self.t1 - reach) / 1e9))
        return sorted(out, key=lambda x: -x[1])

    def breakdown(self, spans: Optional[Spans] = None, top: int = 10):
        """The ``breakdown`` of a result line: the device operations that
        took most time, and the longest idle gaps by host span."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps(spans)[:top]]}
