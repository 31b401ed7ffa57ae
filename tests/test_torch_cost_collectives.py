"""The cost analyzer's collectives and kernel launches: the port's
distributed GS train step under ``cost_analysis.analyze`` on spawned gloo
ranks, against the reference's ``hlo_analysis`` of the same cell.

The cell is ``dryrun.gs_train_cell`` (the reference's
``lower_gs_train_cell``): sphere_shell at res 32, two partitions of 1,300
slots, one view, the trainer's tiered default.

- On ("part",) x 2 the all-gather moves each rank's f32 wire tables (76
  bytes a splat: the 16-column features and the 3-column aux) to the other
  rank: ``wire_bytes_per_splat(tables) * rows * (P - 1)`` bytes, and within
  1% of the reference's compiled on 2 forced host devices (a subprocess,
  as ``tests/test_tools.py:240-257`` runs the reference).  XLA splits the
  gather into the same two tables (two all-gather sites, 83,200 + 15,600
  bytes); the sums are compared.
- On ("pod", "part", "model") 2 x 1 x 1 the "part" group holds one rank,
  so no all-gather is counted (``Mesh.group`` gives None and the step
  issues none), and the only pod-spanning traffic is scalars: the loss
  partials' psum (4 float32) and its transpose, 2 x 16 bytes, and the
  overflow counters' sums (2 + 1 int64), 24 bytes.  The reference's record
  of the same mesh reads 28 bytes (its transpose of the loss psum stays
  local and its counters are int32); both are the scalar metrics
  ``benchmarks/roofline.py:123-127`` allows across pods.
- A recorded launch is charged 27 (forward) or 85 (backward) operations
  per splat-pixel, T * K * tile_h * tile_w, and its bytes once.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import _torch_dist_ranks as ranks  # noqa: E402
from repro_torch.kernels import project as project_kernels  # noqa: E402
from repro_torch.kernels import rasterize  # noqa: E402
from repro_torch.launch.cost_analysis import (KERNEL_OPS,  # noqa: E402
                                              PROJECT_OPS, analyze,
                                              kernel_costs, project_costs)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
from repro.launch import hlo_analysis
from repro.launch.dryrun import lower_gs_train_cell
out = {}
for tag, shape, axes, pod in (("part", (2,), ("part",), 0),
                              ("pod", (2, 1, 1), ("pod", "part", "model"), 1)):
    mesh = jax.make_mesh(shape, axes)
    lowered, meta = lower_gs_train_cell("sphere_shell", mesh, res=32,
                                        n_parts=2, view_batch=1)
    out[tag] = hlo_analysis.analyze(lowered.compile().as_text(),
                                    pod_size=pod)
    out[tag]["meta"] = meta
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks (started first) and the reference's subprocess
    -> ({"part": rank summaries, "pod": rank summaries}, reference)."""
    base = tmp_path_factory.mktemp("cost")
    worlds = {}
    for tag, shape, axes in (("part", (2,), ("part",)),
                             ("pod", (2, 1, 1), ("pod", "part", "model"))):
        out = base / tag
        out.mkdir()
        worlds[tag] = (out, _torch_dist.Ranks(
            ranks.cost_rank, shape, out, str(out), "sphere_shell", 32, 2,
            axes=axes, timeout=300))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", REFERENCE,
                          str(base / "ref.json")], capture_output=True,
                         text=True, timeout=600, env=env)
    got = {}
    for tag, (out, r) in worlds.items():
        r.join()
        got[tag] = [json.loads((out / f"cost_rank{i}.json").read_text())
                    for i in range(2)]
    assert ref.returncode == 0, ref.stderr[-3000:]
    return got, json.loads((base / "ref.json").read_text())


def test_all_gather_wire_bytes(runs):
    got, ref = runs
    for r in got["part"]:
        assert r["meta"] == ref["part"]["meta"]
        assert r["bytes_per_splat"] == 76 and r["rows"] == 1300
        ag = r["collectives"]["all-gather"]
        assert ag["wire_bytes"] == r["bytes_per_splat"] * r["rows"] * (2 - 1)
        assert ag["max_group"] == 2 and r["pod_spanning_bytes"] == 0
        ref_ag = ref["part"]["collectives"]["all-gather"]
        assert ag["count"] == ref_ag["count"] == 2
        assert ag["wire_bytes"] == pytest.approx(ref_ag["wire_bytes"],
                                                 rel=0.01)


def test_pod_spanning_bytes_are_scalars(runs):
    got, ref = runs
    for r in got["pod"]:
        assert set(r["collectives"]) == {"all-reduce"}
        assert r["pod_spanning_bytes"] == r["collective_wire_bytes"] \
            == 2 * 4 * 4 + 3 * 8
    assert 0 < ref["pod"]["pod_spanning_bytes"] <= \
        got["pod"][0]["pod_spanning_bytes"]


@pytest.mark.parametrize("name", ["rasterize_fwd", "rasterize_bwd"])
def test_recorded_launch_is_charged(name):
    """A launch that the kernel's wrapper records (here appended by hand:
    the kernels need a card) is charged its operations per splat-pixel and
    its bytes, under its own name and outside ``matmul_flops``."""
    T, K, F, th, tw = 5, 16, 16, 8, 16

    def launch(x):
        rasterize.RECORDER.append((name, T, K, F, th, tw))
        return x + 1

    r = analyze(launch, torch.zeros(3))
    assert rasterize.RECORDER is None
    ops = KERNEL_OPS[name] * T * K * th * tw
    assert KERNEL_OPS == {"rasterize_fwd": 27, "rasterize_bwd": 85}
    row = r["per_op"][name]
    assert row["count"] == 1 and row["flops"] == ops
    feats, planes = 4 * T * K * F, 4 * T * 4 * th * tw
    want = feats + 8 * T + planes if name == "rasterize_fwd" \
        else 2 * feats + 8 * T + 2 * planes
    assert row["bytes"] == want == kernel_costs(name, T, K, F, th, tw)[1]
    assert r["matmul_flops"] == 0 and r["flops"] == ops + 3


@pytest.mark.parametrize("name", ["project_fwd", "project_bwd"])
def test_recorded_projection_is_charged(name):
    """A projection launch the wrapper records (appended by hand here) is
    charged ``PROJECT_OPS`` a splat and view and its bytes, each read or
    written once, under its own name."""
    V, N = 3, 1000

    def launch(x):
        project_kernels.RECORDER.append((name, V, N))
        return x + 1

    r = analyze(launch, torch.zeros(3))
    assert project_kernels.RECORDER is None
    row = r["per_op"][name]
    ops = PROJECT_OPS[name] * V * N
    # forward: 45 B a splat read, 29 a view written; backward: 40 read and
    # 40 written a splat, 24 of cotangent a view read
    want = N * 45 + V * N * 29 if name == "project_fwd" \
        else N * (40 + 40) + V * N * 24
    assert row["count"] == 1 and row["flops"] == ops
    assert row["bytes"] == want == project_costs(name, V, N)[1]
    assert r["matmul_flops"] == 0 and r["flops"] == ops + 3
