"""The port's spans and counters: where a step or a served batch spends its
time, recorded only while a ``torch.profiler`` session is active.

    from repro_torch.runtime import spans

    with spans.span("train.step", i):
        ...
        spans.count("wire_bytes", n)

Recording is on exactly while ``torch.autograd.profiler._is_profiler_enabled``
is set, the flag PyTorch raises for the length of any profiler session
(whatever its activities).  Off, ``span`` and ``count`` read that flag and
return: no record, no CUDA event, no host sync.

A span records its name, its start and end on the host clock
(``time.time_ns``, the wall-clock base of the profiler's kineto events, so
the spans and the device trace share one clock), its parent span and its
identifiers (``ids``: the step index in training, request ids in
serving).  With CUDA initialised, a span also records a timing
``torch.cuda.Event`` on the current stream at entry and at exit;
``Span.device_ms()`` is the elapsed time between the two, resolved only
when it is read.  That time runs from the device reaching the entry mark
to it reaching the exit mark: it includes any device idle inside the
span, and no work of another stream (NCCL's own included) that the
current stream does not wait for.

A counter is a (name, value) record under the innermost open span.  Spans
nest per thread; a thread with no open span (autograd's device threads,
which run a backward while the calling thread waits in it) records under
the main thread's innermost open span.

Records go into one bounded buffer (``MAX_RECORDS``); once it is full the
oldest record is dropped for each new one, and ``dropped()`` counts them.
A span opened while recording was on is closed and kept even if the
profiler stops inside it; one opened while it was off is not recorded.

Reading: after a profiler session, ``records()`` holds its spans (``Span``)
and counters (``Counter``) in the order they were opened; each has
``t0_ns`` (a counter's time), a span ``t1_ns`` and ``device_ms()``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, List, Optional

import torch
import torch.autograd.profiler as _prof

#: the most records the buffer holds
MAX_RECORDS = 1 << 16

_buffer: "collections.deque" = collections.deque(maxlen=MAX_RECORDS)
_dropped = 0
_seq = itertools.count()
#: thread ident -> that thread's open spans, innermost last
_stacks: dict = {}


class Span:
    """One recorded span; ``t1_ns`` is 0 while it is open."""

    __slots__ = ("name", "ids", "seq", "parent", "t0_ns", "t1_ns", "_ev0",
                 "_ev1", "_ms")

    def __init__(self, name: str, ids: Any, parent: Optional[int]):
        self.name, self.ids, self.parent = name, ids, parent
        self.seq = next(_seq)
        self._ev0 = self._ev1 = self._ms = None
        self.t1_ns = 0
        self.t0_ns = time.time_ns()

    def device_ms(self) -> Optional[float]:
        """Device milliseconds from the entry mark to the exit mark (waits
        for the exit mark); None without marks or while open."""
        if self._ms is None and self._ev1 is not None:
            self._ev1.synchronize()
            self._ms = self._ev0.elapsed_time(self._ev1)
        return self._ms

    def __repr__(self):
        return (f"Span({self.name!r}, ids={self.ids!r}, seq={self.seq}, "
                f"parent={self.parent}, ns=({self.t0_ns}, {self.t1_ns}))")


class Counter:
    """One counter record: ``value`` of ``name`` at ``t0_ns`` under the
    span ``parent`` (a ``Span.seq``, or None)."""

    __slots__ = ("name", "value", "t0_ns", "parent")

    def __init__(self, name: str, value, parent: Optional[int]):
        self.name, self.value, self.parent = name, value, parent
        self.t0_ns = time.time_ns()

    def __repr__(self):
        return (f"Counter({self.name!r}, {self.value!r}, parent="
                f"{self.parent}, ns={self.t0_ns})")


def _keep(rec):
    global _dropped
    if len(_buffer) == _buffer.maxlen:
        _dropped += 1
    _buffer.append(rec)


def _open_parent() -> Optional[int]:
    stack = _stacks.get(threading.get_ident())
    if not stack:
        stack = _stacks.get(threading.main_thread().ident)
    return stack[-1].seq if stack else None


class _Open:
    """The context of a span being recorded."""

    __slots__ = ("rec", "stack")

    def __init__(self, name: str, ids: Any):
        self.rec = Span(name, ids, _open_parent())
        self.stack = _stacks.setdefault(threading.get_ident(), [])

    def tag(self, ids):
        """Set the span's identifiers once they are known."""
        self.rec.ids = ids

    def __enter__(self):
        rec = self.rec
        if torch.cuda.is_initialized():
            rec._ev0 = torch.cuda.Event(enable_timing=True)
            rec._ev0.record()
        self.stack.append(rec)
        _keep(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec._ev0 is not None:
            rec._ev1 = torch.cuda.Event(enable_timing=True)
            rec._ev1.record()
        rec.t1_ns = time.time_ns()
        if self.stack and self.stack[-1] is rec:
            self.stack.pop()
        return False


class _Off:
    """The context ``span`` returns while nothing records."""

    __slots__ = ()

    def tag(self, ids):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, ids: Any = None):
    """A context that records the span ``name`` while a profiler session is
    active (a no-op otherwise).  ``with span(...) as s: s.tag(ids)`` sets
    identifiers known only inside it."""
    if not _prof._is_profiler_enabled:
        return _OFF
    return _Open(name, ids)


def count(name: str, value):
    """Record ``value`` of counter ``name`` under the open span while a
    profiler session is active (a no-op otherwise)."""
    if not _prof._is_profiler_enabled:
        return
    _keep(Counter(name, value, _open_parent()))


def records() -> List[Any]:
    """The buffer's spans and counters, oldest first."""
    return list(_buffer)


def dropped() -> int:
    """Records dropped since the last ``clear`` to keep the bound."""
    return _dropped


def clear():
    """Empty the buffer and zero the drop count."""
    global _dropped
    _buffer.clear()
    _dropped = 0
