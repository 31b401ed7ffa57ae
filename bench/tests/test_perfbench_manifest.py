"""``BENCHMARK.json`` against the benchmark's contract: the keys, names,
units and limits, and every file each entry is found by."""

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from gsbench import manifest  # noqa: E402

M = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(M) == TOP
    assert M["command"] == ["python3", "bench/run.py"]
    assert M["paths"] == ["bench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            yield group, e["name"]


@pytest.mark.parametrize("group,name", list(_names()))
def test_names_are_allowed(group, name):
    assert NAME.match(name), name


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        cfg = json.load(open(BENCH.parent / c["file"]))
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads():
    cells = M["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in cells}
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        cell = manifest.Cell(M, w["name"])
        assert cell.traffic["kind"] in ("train", "serve")
        assert cell.limits


def test_metrics():
    e2e = M["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert any(m["name"] == "setup_s" for m in e2e)
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = {m["name"] for m in e2e}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in names
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in e2e + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                  "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_and_a_layer():
    for w in M["workloads"]:
        cell = manifest.Cell(M, w["name"])
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer()
        moved = {m["moves"] for m in cell.per_layer()}
        assert moved <= e2e
