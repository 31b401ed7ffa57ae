#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine this starts on.

    python3 bench/run.py --workload kingsnake-train --seed 7 --seconds 20 \
        --trace 0

``--workload`` names an entry of ``BENCHMARK.json``'s ``workloads``; the
configuration, traffic mix, limits and per-layer readers it uses are found
by name under ``bench/`` (``gsbench/manifest.py``).  The program under test
is ``repro_torch`` from ``src/``; its compositor is built by ``nvcc`` into
``build/repro_torch_kernels`` at first use, and every other cache is kept
under ``build/bench_cache``, inside the checkout.  A cell on more than one
card starts one process a card (``torch.distributed`` over NCCL, rank 0
reports) and waits for them all.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers the output check compared, each
beside its limit.  No card, too few cards, no program, or a module of JAX
or the JAX package loaded in the process: a non-zero exit and no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from gsbench import manifest  # noqa: E402
from gsbench.harness import (  # noqa: E402
    Run, device_info, emit, forbidden_loaded, log)

#: the longest a many-card run may take, first build included
RANKS_TIMEOUT_S = 1500

CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the launcher for each rank of a many-card cell
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def fixed_caches():
    for var, sub in CACHES.items():
        path = ROOT / "build" / "bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return "; ".join(x.strip() for x in out.splitlines() if x.strip())


def launch_ranks(args, cell) -> int:
    """Start one process a card, rank 0's standard output on a pipe; wait
    for every one (stopping the rest once one fails or the time is up);
    print rank 0's result."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(cell.chips):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE=str(cell.chips), LOCAL_RANK=str(r))
        argv = [sys.executable, str(Path(__file__).resolve()),
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--rank", str(r), "--t-start", str(T_START)]
        procs.append(subprocess.Popen(
            argv, env=env, cwd=ROOT, text=True, start_new_session=True,
            stdout=subprocess.PIPE if r == 0 else sys.stderr))
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(procs[0].stdout))
    reader.start()
    deadline = time.time() + RANKS_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        reader.join()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        log(f"ranks exited {rcs}")
        return 1
    lines = [ln.rstrip("\n") for ln in lines if ln.strip()]
    for ln in lines[:-1]:
        print(ln, flush=True)
    bad = forbidden_loaded()
    if bad:
        log(f"loaded in the reporting process: {bad}")
        return 4
    result = json.loads(lines[-1])
    checks = result.pop("checks")
    emit(result, checks)
    return 0


def finish(out: dict, run: Run, cell) -> int:
    bad = sorted(set(out["forbidden"]) | set(forbidden_loaded()))
    if bad:
        log(f"modules loaded once the window closed: {bad}")
        return 4
    print(f"[bench] {cell.name} seed {run.seed}: {card_line()}; "
          f"{out['device_count']} card(s) of {_count()} visible", flush=True)
    ctx = out["ctx"]
    if run.trace:
        metrics = manifest.read_metrics(cell, ctx)
        busy = [b for b in ctx.busy if b is not None]
        dev = device_info(out["device_count"], out["memory_peak_bytes"],
                          ctx.trace, sum(busy) / len(busy) if busy else None)
    else:
        # a cell's metric "<quantity>.<suffix>" reads the driver's quantity
        metrics = {m["name"]: {"value": float(out["e2e"][base]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end()
                   if (base := m["name"].split(".")[0]) in out["e2e"]}
        dev = device_info(out["device_count"], out["memory_peak_bytes"])
    if ctx.telemetry is not None:
        print(f"[bench] telemetry {json.dumps(ctx.telemetry)}", flush=True)
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if run.trace and ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown(ctx.spans)
    emit(result, out["checks"])
    return 0


def _count() -> int:
    import torch
    return torch.cuda.device_count()


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    cell = manifest.Cell(manifest.load(), args.workload)
    if cell.chips > 1 and args.rank is None:
        # the ranks look for their cards; this process stays off them
        return launch_ranks(args, cell)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not in this checkout: {e}")
        return 3
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              t_start=args.t_start or T_START)
    if cell.traffic["kind"] == "train":
        from gsbench.train import run_train as drive
    else:
        from gsbench.serve import run_serve as drive
    out = drive(run)
    if out is None:
        return 0
    return finish(out, run, cell)


if __name__ == "__main__":
    sys.exit(main())
