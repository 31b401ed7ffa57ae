"""The readers of the program's own spans and counters
(``gsbench/program_spans.py`` and the sixteen ``metrics/*.py`` that use
it), against synthetic spans, counters and device intervals whose
answers are worked by hand below."""

import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from gsbench import manifest, program_spans  # noqa: E402


class Span:
    def __init__(self, name, t0, t1, ms=None):
        self.name, self.t0_ns, self.t1_ns, self._ms = name, t0, t1, ms

    def device_ms(self):
        return self._ms


class Counter:
    def __init__(self, name, value, t0):
        self.name, self.value, self.t0_ns = name, value, t0


def _ctx(t0, t1, intervals):
    trace = types.SimpleNamespace(t0=t0, t1=t1, intervals=[
        (a, b, "k") for a, b in intervals])
    return types.SimpleNamespace(trace=trace)


# Training: window [1000, 21000] ns; the device busy [500, 3000], [4000,
# 9000], [10000, 19000], so idle (3000, 4000), (9000, 10000), (19000,
# 21000).  Two steps start in the window; the step before it and its
# counter are left out, the tail of the window's first step (its
# schedule) is in.
TRAIN = [
    Span("train.step", 0, 900), Span("project", 100, 200, 99.0),
    Counter("wire_bytes", 999, 500),
    Span("train.schedule", 1500, 2500),
    Span("train.step", 2600, 12000),
    Span("train.batch", 2600, 3500),                 # idle 3000-3500: 500
    Span("train.forward", 3500, 6000, 4.0),
    Span("project", 3600, 3800, 1.5), Counter("wire_bytes", 1024, 3700),
    Span("project", 3800, 3900, 0.5),
    Span("train.backward", 6000, 8000, 5.0),
    Span("train.adam", 8000, 8500, 0.4),
    Span("train.readback", 8500, 9500),              # with the schedule,
    Span("train.schedule", 9500, 9800),              # idle 9000-9800: 800
    Span("train.step", 12000, 22000),
    Span("train.batch", 12000, 12100),               # busy
    Span("train.forward", 12100, 15000, 3.0),
    Span("project", 12200, 12300, 1.0),
    Span("train.backward", 15000, 18000, 6.0),
    Counter("wire_bytes", 2048, 15500),
    Span("train.readback", 18000, 20000),            # with the schedule,
    Span("train.schedule", 20000, 21500),            # idle 19000-21000
]
TRAIN_BUSY = [(500, 3000), (4000, 9000), (10000, 19000)]

# Serving: window [0, 10000]; busy [1000, 4000], [5000, 8000], so idle
# (0, 1000), (4000, 5000), (8000, 10000).  One batch; serve.* spans cover
# (100, 500) and (600, 9000): idle under them 400 + 400 + 1000 + 1000.
SERVE = [
    Span("serve.submit", 100, 300), Span("serve.submit", 300, 500),
    Span("serve.flush", 600, 9000),
    Span("serve.dispatch", 700, 8800),
    Span("serve.tables", 700, 3000, 2.1),
    Span("serve.assign", 800, 2900, 2.0),
    Span("project", 900, 1000, 0.7),
    Span("serve.render", 3000, 6000, 3.0),
    Span("project", 3100, 3200, 0.6),
    Span("serve.readback", 6000, 8500, 2.5),
    Counter("readback_bytes", 4096, 8000),
]
SERVE_BUSY = [(1000, 4000), (5000, 8000)]

CASES = [
    ("kingsnake-train", "project_ms.train", (1.5 + 0.5 + 1.0) / 2),
    ("rayleigh_taylor-train-4", "project_ms.four_cards", 1.5),
    ("kingsnake-train", "forward_ms.train", (4.0 + 3.0) / 2),
    ("rayleigh_taylor-train-4", "forward_ms.four_cards", 3.5),
    ("kingsnake-train", "backward_ms.train", (5.0 + 6.0) / 2),
    ("rayleigh_taylor-train-4", "backward_ms.four_cards", 5.5),
    ("kingsnake-train", "sync_idle_ms.train", (500 + 800 + 2000) / 1e6 / 2),
    ("rayleigh_taylor-train-4", "sync_idle_ms.four_cards", 3300 / 1e6 / 2),
    ("rayleigh_taylor-train-4", "wire_mib.four_cards",
     (1024 + 2048) / 2 / 2**20),
    ("kingsnake-serve-novel", "assign_ms.serve", 2.0),
    ("kingsnake-serve-novel", "project_ms.serve", 0.7 + 0.6),
    ("kingsnake-serve-orbit", "project_ms.cached", 1.3),
    ("kingsnake-serve-novel", "readback_ms.serve", 2.5),
    ("kingsnake-serve-orbit", "readback_ms.cached", 2.5),
    ("kingsnake-serve-novel", "program_idle_share.serve", 28.0),
    ("kingsnake-serve-orbit", "program_idle_share.cached", 28.0),
]


def _reader(cell, metric):
    c = manifest.Cell(manifest.load(), cell)
    assert metric in {m["name"] for m in c.per_layer()}
    return c.reader(metric)


def _world(cell):
    if "train" in cell:
        return TRAIN, _ctx(1000, 21000, TRAIN_BUSY)
    return SERVE, _ctx(0, 10000, SERVE_BUSY)


@pytest.mark.parametrize("cell,metric,want", CASES,
                         ids=[c[1] for c in CASES])
def test_reader_hand_worked(cell, metric, want, monkeypatch):
    recs, ctx = _world(cell)
    monkeypatch.setattr(program_spans, "recorded", lambda: recs)
    assert _reader(cell, metric)(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("cell,metric,want", CASES,
                         ids=[c[1] for c in CASES])
def test_reader_none_without_spans(cell, metric, want, monkeypatch):
    """No recorder (a program without one), no records, no trace, or
    records of the other kind of cell: None."""
    read = _reader(cell, metric)
    _, ctx = _world(cell)
    other = SERVE if "train" in cell else TRAIN
    for recs in (None, [], other):
        monkeypatch.setattr(program_spans, "recorded", lambda: recs)
        assert read(ctx) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: _world(cell)[0])
    assert read(types.SimpleNamespace(trace=None)) is None


def test_idle_gaps_clip_to_the_window():
    ctx = _ctx(1000, 21000, TRAIN_BUSY)
    assert program_spans.idle_gaps(ctx) == [(3000, 4000), (9000, 10000),
                                            (19000, 21000)]
    # a device busy past both edges leaves no gap
    assert program_spans.idle_gaps(_ctx(10, 20, [(0, 15), (12, 30)])) == []


def test_recorded_without_the_program(monkeypatch):
    """A checkout whose program has no recorder reads as None."""
    monkeypatch.setitem(sys.modules, "repro_torch.runtime", None)
    assert program_spans.recorded() is None
