"""What every cell's run shares: its context, the in-memory checkpoint that
carries training state between ``fit_partitions`` calls, the look for
modules the run must not hold, the output check's verdict, and the
result line.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

from gsbench.trace import Spans

#: top-level module names a run must not have loaded: JAX and the JAX
#: package, compared whole (the program's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """One run of one cell on this process's device."""
    cell: object                 # manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.time)
    spans: Spans = dataclasses.field(default_factory=Spans)

    def say(self, msg: str):
        log(f"[{self.cell.name}] {msg}")


class MemoryCheckpoint:
    """``fit_partitions``' checkpoint interface held in device memory: a
    call that starts with it resumes from the last state saved into it
    (the global (P, N) tree and the schedule's extras), no files.  The
    tree is handed over on restore and the reference dropped, so the
    state is not held twice while a call runs."""

    def __init__(self):
        self.step: Optional[int] = None
        self.tree = None
        self.extra: Optional[dict] = None

    def latest_restorable_step(self):
        return self.step

    def manifest_extra(self, step):
        return self.extra

    def restore(self, step, like, device=None):
        tree, self.tree = self.tree, None
        return tree, self.extra

    def save(self, step, tree, extra=None):
        self.step, self.tree, self.extra = step, tree, extra


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """-> (every reading within its limit, {name: {value, limit}}).  A
    number with no reading (NaN or missing) fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def emit(result: dict, checks: Dict[str, dict]):
    """Print the numbers compared as the last lines of standard error and
    the result as the last line of standard output, checks last."""
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    out = dict(result)
    out["checks"] = checks
    print(json.dumps(out), flush=True)


def device_info(count: int, peak_bytes: int, trace=None,
                busy_s: Optional[float] = None) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        info["busy_s"] = busy_s
        info["window_s"] = trace.window_s
    return info
