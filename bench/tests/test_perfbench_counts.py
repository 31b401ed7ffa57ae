"""The yardstick's counts reproduce the compositor bounds in PERF.md's
table of kernels (27 and 85 operations a splat-pixel at 67 TFLOP/s, or the
bytes at 3.35 TB/s, whichever is longer), and a step's count grows with
its shapes."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gsbench import counts  # noqa: E402

# (kernel, tiles, K, tile_h, tile_w, bound ms in PERF.md)
ROWS = [
    ("rasterize_fwd", 32768, 64, 16, 16, 0.2164),
    ("rasterize_fwd", 16384, 64, 8, 16, 0.05409),
    ("rasterize_fwd", 16, 8, 16, 16, 0.0000220),
    ("rasterize_fwd", 16248, 64, 8, 16, 0.05364),
    ("rasterize_bwd", 4096, 64, 16, 16, 0.08514),
    ("rasterize_bwd", 16, 8, 16, 16, 0.0000441),
    ("rasterize_bwd", 72, 32, 8, 16, 0.000374),
    ("rasterize_bwd", 16248, 64, 8, 16, 0.1689),
]


@pytest.mark.parametrize("name,T,K,th,tw,ms", ROWS)
def test_kernel_bound_matches_the_table(name, T, K, th, tw, ms):
    got = counts.kernel_bound_s(name, T, K, 16, th, tw) * 1e3
    assert got == pytest.approx(ms, rel=5e-3)


def test_ops_per_splat_pixel():
    assert counts.KERNEL_OPS == {"rasterize_fwd": 27, "rasterize_bwd": 85}


def test_step_counts_scale_with_shapes():
    base = dict(partitions=2, slots=1000, views=1, width=64, height=64, K=64)
    one = counts.train_step_flops(**base)
    assert counts.train_step_flops(**dict(base, partitions=4)) == 2 * one
    assert counts.train_step_flops(**dict(base, slots=2000)) > one
    s = counts.serve_request_flops(splats=1000, width=64, height=64, K=64)
    assert s == 1000 * counts.PROJECT_OPS + 64 * 64 * 64 * 27
