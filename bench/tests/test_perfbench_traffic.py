"""The traffic generators and the input draws: a seed repeats exactly,
seeds differ, and each mix keeps to what it is for."""

import json
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from gsbench import scene  # noqa: E402

CENTER, RADIUS = np.array([0.5, 0.5, 0.5]), 0.86


def _bucket(view, bins=1024.0):
    """The serving lattice bucket of a view matrix."""
    return tuple(int(x) for x in np.rint(np.asarray(view, np.float64)
                                         .reshape(-1) * bins))


def _mix(name):
    return json.load(open(BENCH / "traffic" / f"{name}.json"))


def _draw(mix, seed, n):
    p = scene.ViewerPoses(mix, CENTER, RADIUS, seed)
    return [p.next(i % p.viewers) for i in range(n)]


def test_serving_poses_repeat_for_a_seed_and_differ_across_seeds():
    for name in ("serve_novel", "serve_orbit"):
        mix = _mix(name)
        a, b = _draw(mix, 2**31 + 7, 64), _draw(mix, 2**31 + 7, 64)
        c = _draw(mix, 8, 64)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_orbit_working_set_fits_the_cache():
    mix = _mix("serve_orbit")
    cfg = json.load(open(BENCH / "configs" / "kingsnake.json"))
    keys = {_bucket(v) for v in _draw(mix, 5, 1000)}
    assert len(keys) == mix["viewers"] * mix["ring_size"]
    assert len(keys) <= cfg["serve"]["cache_entries"]


def test_novel_poses_never_repeat_a_bucket():
    keys = [_bucket(v) for v in _draw(_mix("serve_novel"), 5, 1000)]
    assert len(set(keys)) == 1000


def test_serving_distances_stay_on_the_first_rung():
    for name in ("serve_novel", "serve_orbit"):
        for v in _draw(_mix(name), 3, 200):
            eye = -v[:3, :3].astype(np.float64).T @ v[:3, 3]
            assert np.linalg.norm(eye - CENTER) < 4 * RADIUS


def test_rows_and_rig():
    r = scene.select_rows(1000, 900, 2**31 + 1)
    assert len(set(r)) == 900 and np.array_equal(
        r, scene.select_rows(1000, 900, 2**31 + 1))
    assert not np.array_equal(r, scene.select_rows(1000, 900, 2))
    assert np.array_equal(scene.select_rows(500, 900, 3), np.arange(500))
    rig = scene.train_views(16, CENTER, 1.7)
    assert rig.shape == (16, 4, 4) and rig.dtype == np.float32
