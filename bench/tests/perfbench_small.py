"""Small sizes and a runner for the benchmark's CPU tests: a cell of
``BENCHMARK.json`` driven on the CPU at a size a test run holds (the
harness's look for a card skipped), and its ranks for a many-card cell
(gloo).  Each configuration's small twin is ``small/<config>.json`` beside
this file, found by name."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from gsbench import manifest  # noqa: E402
from gsbench.harness import Run  # noqa: E402


def twin(config: str, bench: Path = BENCH) -> dict:
    """Configuration ``config``'s small twin, ``tests/small/<config>.json``
    of the benchmark at ``bench``."""
    with open(bench / "tests" / "small" / f"{config}.json") as f:
        return json.load(f)


#: every small twin of this benchmark, by configuration
CONFIGS = {p.stem: twin(p.stem) for p in sorted(
    (BENCH / "tests" / "small").glob("*.json"))}


def small_cell(workload: str, bench: Path = BENCH) -> "manifest.Cell":
    """``workload`` of the benchmark at ``bench`` (its ``BENCHMARK.json``
    beside it) at the small size: its configuration's small twin, four
    viewers."""
    man = manifest.load(bench.parent / "BENCHMARK.json")
    spec = next(w for w in man["workloads"] if w["name"] == workload)
    tr = json.load(open(bench / "traffic" / f"{spec['traffic']}.json"))
    if tr["kind"] != "train":
        tr.update(viewers=4, check_max=4)
    return manifest.Cell(man, workload, bench,
                         config=twin(spec["config"], bench), traffic=tr)


def drive(workload: str, seed: int = 2**31 + 5, seconds: float = 1.0,
          bench: Path = BENCH):
    """One run of ``workload`` of the benchmark at ``bench`` on the CPU ->
    ``run_train`` / ``run_serve``'s result.  The process's thread count and
    process group are left as they were."""
    import torch
    import torch.distributed as dist
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    cell = small_cell(workload, bench)
    run = Run(cell, seed, seconds, False, device="cpu")
    if cell.traffic["kind"] == "train":
        from gsbench.train import run_train as go
    else:
        from gsbench.serve import run_serve as go
    had_group = dist.is_initialized()
    try:
        return go(run)
    finally:
        torch.set_num_threads(threads)
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()


def drive_ranks(workload: str, n: int, fault: str, out: Path,
                timeout: float = 300.0):
    """Run ``workload`` on ``n`` gloo ranks of this file (``fault`` planted
    in each) -> rank 0's result as written to ``out``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, workload, fault, str(out)], env=env,
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"ranks exited {rcs}: "
                           + errs[rcs.index(next(c for c in rcs if c))]
                           .decode()[-3000:])
    return json.loads(out.read_text())


def plant(fault: str):
    """Break the program's timed path in this process."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D

    if fault == "none":
        return
    if fault == "no_exchange":
        def local_only(x, group, dim):
            # the "part" all-gather left out: the other ranks' rows are 0
            if group is None:
                return x
            rows = [torch.zeros_like(x)] * dist.get_world_size(group)
            rows[dist.get_rank(group)] = x
            return torch.cat(rows, dim)
        D._gather = local_only
        return
    raise ValueError(fault)


if __name__ == "__main__":
    workload, fault, out = sys.argv[1:4]
    plant(fault)
    res = drive(workload)
    if res is not None:
        Path(out).write_text(json.dumps(
            {k: v for k, v in res.items() if k != "ctx"}))
