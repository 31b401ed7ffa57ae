"""The result line and the check lines a run prints, from a driver's
result, without a card (the device fields stubbed)."""

import importlib.util
import json
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from gsbench import manifest  # noqa: E402
from gsbench.harness import Run  # noqa: E402

spec = importlib.util.spec_from_file_location("perfbench_run",
                                              BENCH / "run.py")
runpy = importlib.util.module_from_spec(spec)
spec.loader.exec_module(runpy)


def _out(e2e, ctx_kind="serve"):
    ctx = types.SimpleNamespace(kind=ctx_kind, trace=None, spans=None,
                                launches=[], window_s=20.0, steps=0,
                                step_times=[], requests=10,
                                telemetry={"hits": 3, "misses": 7},
                                shapes={}, cards=1, busy=[None])
    return {"correct": True, "attempted": 10, "failed": 0, "e2e": e2e,
            "device_count": 1, "memory_peak_bytes": 123, "forbidden": [],
            "ctx": ctx,
            "checks": {"image_gap": {"value": 1e-7, "limit": 1e-5}}}


@pytest.fixture
def no_card(monkeypatch):
    # this test process may hold the JAX package from other test files;
    # the look for it is the harness's own, stubbed here
    monkeypatch.setattr(runpy, "forbidden_loaded", lambda: [])
    monkeypatch.setattr(runpy, "device_info", lambda count, peak, *a: {
        "platform": "gpu", "kind": "stub", "count": count,
        "memory_peak_bytes": peak})
    monkeypatch.setattr(runpy, "_count", lambda: 1)
    monkeypatch.setattr(runpy, "card_line", lambda: "stub")


@pytest.mark.parametrize("workload,names", [
    ("kingsnake-serve-orbit", {"serve_req_per_s.cached", "peak_mem_gib",
                               "setup_s"}),
    ("kingsnake-serve-novel", {"serve_req_per_s", "serve_p95_ms",
                               "peak_mem_gib", "setup_s"})])
def test_result_line(workload, names, no_card, capsys):
    cell = manifest.Cell(manifest.load(), workload)
    out = _out({"serve_req_per_s": 30.0, "serve_p95_ms": 250.0,
                "peak_mem_gib": 6.0, "setup_s": 15.0})
    assert runpy.finish(out, Run(cell, 1, 20.0, False), cell) == 0
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == names
    assert line["checks"]["image_gap"] == {"value": 1e-7, "limit": 1e-5}
    assert cap.err.strip().splitlines()[-1] == \
        "check image_gap 1e-07 limit 1e-05"


def test_forbidden_module_gives_no_result(no_card, capsys):
    cell = manifest.Cell(manifest.load(), "kingsnake-serve-novel")
    out = _out({"serve_req_per_s": 30.0})
    out["forbidden"] = ["jax"]
    assert runpy.finish(out, Run(cell, 1, 20.0, False), cell) != 0
    assert capsys.readouterr().out == ""
