"""Time the port's CUDA compositor kernels against another checkout's, in
turns, on one card.

    python3 tools/torch_kernel_ab.py --other DIR [--inputs DIR] [--out FILE]

``--other`` is the root of another checkout of this repository (for
example ``git archive <commit>`` unpacked under the git-ignored
``build/``); its ``src/repro_torch/kernels/rasterize.py`` is loaded under
another module name and builds its own kernels into its own ``build/``.
``--inputs`` is a directory written by ``chip_smoke.py --save-inputs``:
the serving dispatch's tile table (``serve.pt``) and one train step's tier
tables with their cotangents (``train.pt``).  Without it the shapes are
the same, filled with ``chip_smoke.tile_inputs`` rows from a seed: the
serving shape (32768 tiles of 16 x 16, K = 64) and tiers of 16, 24 and
4096 tiles at K = 8, 32 and 64.

For every shape: the forward of both checkouts (``torch.equal`` reported)
and, on the train tiers, the backward of both (max abs difference and the
2e-4 gate between them; two runs of each ``torch.equal``), each timed in
turns other, this, this, other with ``chip_smoke.kernel_times`` (CUDA
events over back-to-back launches).  One JSON line per shape, the card's
name and power limit first; ``--out`` also writes them all to a file.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import rasterize  # noqa: E402


def load_other(root: Path):
    path = root / "src" / "repro_torch" / "kernels" / "rasterize.py"
    spec = importlib.util.spec_from_file_location("other_rasterize", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def shapes(inputs):
    """-> [(label, feats, origins, gout or None, th, tw)]."""
    if inputs is not None:
        serve = torch.load(Path(inputs) / "serve.pt")
        train = torch.load(Path(inputs) / "train.pt")
        th, tw = serve["tile"]
        out = [("serve", serve["feats"], serve["origins"], None, th, tw)]
        th, tw = train["tile"]
        for k, tf, og, _, gout in train["tiers"]:
            out.append((f"train K={k}", tf, og, gout, th, tw))
        return out
    rng = np.random.default_rng(0)
    out = []
    for label, T, K in (("serve", 32768, 64), ("train K=8", 16, 8),
                        ("train K=32", 24, 32), ("train K=64", 4096, 64)):
        f, o = chip_smoke.tile_inputs(rng, T, K, 16, 16, "cuda")
        gout = None
        if label != "serve":
            gout = torch.tensor(rng.normal(size=(T, 4, 16, 16)),
                                dtype=torch.float32, device="cuda")
        out.append((label, f, o, gout, 16, 16))
    return out


def in_turns(fn_other, fn_this, reps):
    """other, this, this, other -> (this ms, other ms, the four runs)."""
    runs = [chip_smoke.kernel_times(fn, reps)
            for fn in (fn_other, fn_this, fn_this, fn_other)]
    ms = [r["ms"] for r in runs]
    return statistics.median(ms[1:3]), statistics.median([ms[0], ms[3]]), ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--other", required=True, type=Path)
    parser.add_argument("--inputs")
    parser.add_argument("--reps", type=int, default=15)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    other = load_other(args.other.resolve())
    rasterize.build()
    other.build()
    lines = [{"card": card}]
    for label, f, o, gout, th, tw in shapes(args.inputs):
        tile = dict(tile_h=th, tile_w=tw)
        this_out = rasterize.rasterize_fwd(f, o, **tile)
        other_out = other.rasterize_fwd(f, o, **tile)
        ms, other_ms, runs = in_turns(
            lambda: other.rasterize_fwd(f, o, **tile),
            lambda: rasterize.rasterize_fwd(f, o, **tile), args.reps)
        row = {"shape": label, "kernel": "rasterize_fwd", "tiles": f.shape[0],
               "K": f.shape[1], "tile": [th, tw],
               "equal": torch.equal(this_out, other_out),
               "ms": ms, "other_ms": other_ms, "runs_other_this_this_other":
               runs}
        print(json.dumps(row), flush=True)
        lines.append(row)
        if gout is None:
            continue
        planes = (f, o, this_out, gout)
        got = rasterize.rasterize_bwd(*planes, **tile)
        want = other.rasterize_bwd(*planes, **tile)
        ms, other_ms, runs = in_turns(
            lambda: other.rasterize_bwd(*planes, **tile),
            lambda: rasterize.rasterize_bwd(*planes, **tile), args.reps)
        row = {"shape": label, "kernel": "rasterize_bwd", "tiles": f.shape[0],
               "K": f.shape[1], "tile": [th, tw],
               "max_abs_diff": (got - want).abs().max().item(),
               "gate_2e-4": chip_smoke.bwd_gate(got, want,
                                                chip_smoke.BWD_EMUL_TOL),
               "repeatable": torch.equal(
                   got, rasterize.rasterize_bwd(*planes, **tile))
               and torch.equal(want, other.rasterize_bwd(*planes, **tile)),
               "ms": ms, "other_ms": other_ms, "runs_other_this_this_other":
               runs}
        print(json.dumps(row), flush=True)
        lines.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
