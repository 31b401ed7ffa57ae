"""The output check's control: the plain reference in TF32 put in the
program's place must come out not correct, against the limits of the cell
it stands for.

On the CPU at a small size (the gaps there are of the same kind, and each
must still exceed the cell's limit); with a card (``-m cuda``) at every
cell's own size on three seeds, printing each reading (``-s``):

    python -m pytest -q -s -m cuda bench/tests/test_perfbench_control.py
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsbench import control, manifest, scene  # noqa: E402
from gsbench.harness import judge  # noqa: E402

SMALL = {"field": "gyroid", "iso": 0.0, "resolution": 20,
         "max_crossings": 20000, "points": 2500, "views": 4, "image": 64,
         "partitions": 2,
         "train": {"tile_h": 8, "tile_w": 16, "K": 16,
                   "capacity_factor": 1.3, "ghost_frac": 0.03,
                   "masks": True, "dtype_policy": "f32",
                   "init_opacity": 0.6, "gt_opacity": 0.95},
         "serve": {"tile_h": 16, "tile_w": 16, "K": 16, "max_batch": 4,
                   "cache_entries": 64, "opacity": 0.9}}
CARD_SEEDS = (3, 2**31 + 11, 4242)


def _cells():
    return [w["name"] for w in manifest.load()["workloads"]]


def _readings(cell, cfg, seed, dev, n_views=None, src=scene.DENSE):
    if cell.traffic["kind"] == "train":
        return control.train_readings(cfg, seed, dev, src=src)
    tr = copy.deepcopy(cell.traffic)
    if n_views:
        tr["viewers"] = n_views
    return control.serve_readings(cfg, tr, seed, dev, n=n_views or 8,
                                  src=src)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control at a cell's size")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["kingsnake-train",
                                      "kingsnake-serve-novel"])
def test_control_fails_small(workload):
    cell = manifest.Cell(manifest.load(), workload)
    cfg = copy.deepcopy(SMALL)
    r = _readings(cell, cfg, 1, torch.device("cpu"), n_views=4)
    ok, checks = judge(r, cell.limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_at_cell_size(workload, card):
    cell = manifest.Cell(manifest.load(), workload)
    for seed in CARD_SEEDS:
        r = _readings(cell, cell.config, seed, card, src=scene.source(cell))
        ok, checks = judge(r, cell.limits)
        print(f"control {workload} seed {seed}: {checks}", flush=True)
        assert not ok, checks


def _faults():
    for w in manifest.load()["workloads"]:
        if w["traffic"].startswith("train"):
            yield w["name"], "half_batch"
            if w["chips"] > 1:
                yield w["name"], "no_exchange"


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", list(_faults()))
def test_training_faults_at_cell_size(workload, fault, card):
    """Each fault a training cell can have, planted in the reference put
    in the program's place, at the cell's size (its readings bound the
    limits from above where they are under the control's)."""
    cell = manifest.Cell(manifest.load(), workload)
    for seed in CARD_SEEDS:
        r = control.train_readings(cell.config, seed, card, fault=fault,
                                   ranks=cell.chips, src=scene.source(cell))
        ok, checks = judge(r, cell.limits)
        print(f"fault {fault} {workload} seed {seed}: {checks}", flush=True)
        assert not ok, checks


@pytest.mark.parametrize("fault,ranks", [("half_batch", 1),
                                         ("no_exchange", 4)])
def test_training_faults_small(fault, ranks):
    cell = manifest.Cell(manifest.load(), "kingsnake-train")
    r = control.train_readings(copy.deepcopy(SMALL), 1, torch.device("cpu"),
                               fault=fault, ranks=ranks)
    ok, checks = judge(r, cell.limits)
    assert not ok, checks
