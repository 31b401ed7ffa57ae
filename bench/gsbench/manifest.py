"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
``configs/<name>.json`` holds the configuration as it is run,
``scenes/<name>.py``, where a configuration brings one, its point source
(``scene.source``: the program's points and the reference's, which may
make the field slab by slab; without it the field is made whole),
``tests/small/<name>.json`` its small twin for the CPU tests,
``traffic/<name>.json`` the mix's parameters (its ``kind`` picks the
general driver that reads them: ``train`` or ``serve``),
``limits/<cell>.json`` the limit of each number the output check compares,
and ``metrics/<metric>.py`` the reader of each per-layer metric.  A later
change adds a configuration, a cell, a mix or a metric by adding such
files.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload with everything the run needs."""

    def __init__(self, manifest: dict, name: str, bench: Path = BENCH, *,
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None,
                 limits: Optional[dict] = None):
        """``config`` / ``traffic`` / ``limits`` replace the files' (a
        test's small sizes)."""
        self.manifest = manifest
        self.spec = _by_name(manifest["workloads"], name, "workload")
        self.name = name
        conf = _by_name(manifest["configs"], self.spec["config"],
                        "configuration")
        self.config = config or _json(bench.parent / conf["file"])
        self.traffic = traffic or _json(
            bench / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = limits if limits is not None else _json(
            bench / "limits" / f"{name}.json")
        self.chips = int(self.spec["chips"])
        self.bench = bench

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics read in this cell's traced run: those that
        list it, and those without a list whose moved metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.manifest["per_layer"]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in mine:
                out.append(m)
        return out

    def reader(self, metric: str) -> Callable:
        """``metrics/<metric>.py``'s ``read(ctx) -> float | None``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "gsbench_metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_metrics(cell: Cell, ctx) -> Dict[str, dict]:
    """Every per-layer metric of ``cell`` that finds something to read."""
    out = {}
    for m in cell.per_layer():
        value: Optional[float] = cell.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
