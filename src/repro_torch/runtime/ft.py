"""Fault tolerance: step retry, heartbeats, straggler-tolerant merge.

Port of ``repro.runtime.ft`` (plain Python; ``bounded_staleness_merge``
restores through the port's ``CheckpointManager`` onto ``device=``).

The paper's partition independence is the backbone of the FT story: a failed
node invalidates ONE partition, which restores from its own checkpoint and
retrains alone (cost O(1/n) of the job), while the merge proceeds with
*bounded staleness* — it reads the latest complete checkpoint of every
partition rather than blocking on the barrier (DESIGN.md §6).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, List, Optional


def retry_step(fn: Callable, *args, retries: int = 2,
               on_failure: Optional[Callable] = None, **kw):
    """Run a (re-runnable, functional) step with retry.

    Training steps here are pure functions of (state, batch) — a transient
    failure (preempted host, flaky interconnect) is retried with the SAME
    inputs, so retries are semantically invisible.  Deterministic failures
    exhaust retries and re-raise.
    """
    err = None
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 — deliberate catch-all boundary
            err = e
            if on_failure is not None:
                on_failure(attempt, e)
    raise err


class Heartbeat:
    """Health-file heartbeat for external watchdogs.

    Each worker touches ``<dir>/hb_<name>.json`` every ``interval`` seconds
    with its step counter; an external supervisor (or another worker) calls
    ``stale()`` to list members whose heartbeat is older than ``timeout`` —
    those are straggler/failure suspects whose partitions get rescheduled.
    """

    def __init__(self, dir: str, name: str, *, interval: float = 10.0):
        self.dir = dir
        self.name = name
        self.interval = interval
        self._last = 0.0
        os.makedirs(dir, exist_ok=True)

    def path(self, name: Optional[str] = None) -> str:
        return os.path.join(self.dir, f"hb_{name or self.name}.json")

    def beat(self, step: int, force: bool = False, **info):
        now = time.time()
        if not force and now - self._last < self.interval:
            return
        self._last = now
        tmp = self.path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"time": now, "step": step, **info}, f)
        os.replace(tmp, self.path())

    def stale(self, timeout: float, now: Optional[float] = None) -> List[str]:
        now = now or time.time()
        out = []
        for fn in os.listdir(self.dir):
            if not fn.startswith("hb_"):
                continue
            try:
                with open(os.path.join(self.dir, fn)) as f:
                    hb = json.load(f)
            except Exception:
                out.append(fn[3:-5])
                continue
            if now - hb["time"] > timeout:
                out.append(fn[3:-5])
        return sorted(out)


def bounded_staleness_merge(ckpt_mgr, n_parts: int, like: Any, *,
                            max_lag: int = 0, device="cuda"):
    """Merge inputs under stragglers: for each partition pick its LATEST
    complete checkpoint (optionally requiring step >= newest - max_lag).

    Returns (list of restored trees, list of steps used, laggards). The
    caller merges with core/merge.py; a laggard beyond max_lag is reported
    so the supervisor can reschedule it, but the merge never blocks.
    """
    newest = ckpt_mgr.latest_step()
    assert newest is not None, "no checkpoints at all"
    trees, steps, laggards = [], [], []
    for p in range(n_parts):
        got = None
        for s in reversed(ckpt_mgr.all_steps()):
            d = ckpt_mgr._step_dir(s, p)
            if os.path.exists(os.path.join(d, "_COMPLETE")):
                got = s
                break
        assert got is not None, f"partition {p} has no checkpoint"
        if max_lag and newest - got > max_lag:
            laggards.append(p)
        tree, _ = ckpt_mgr.restore(got, like, partition=p, device=device)
        trees.append(tree)
        steps.append(got)
    return trees, steps, laggards
