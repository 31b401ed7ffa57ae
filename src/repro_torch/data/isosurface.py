"""Isosurface point clouds for the analytic volumes.

Port of ``repro.data.isosurface``: marching-cubes-style *edge-crossing*
extraction -- for every grid edge along x/y/z where the field crosses the
iso value, emit the linearly-interpolated crossing point.

- ``point_cloud_for`` (and its parts ``resolution_for`` and
  ``crossing_points``) is the reference's numpy host code, unchanged, so
  both packages seed their Gaussians from bit-identical point clouds.
- ``extract_isosurface`` is the reference's fixed-capacity extractor on
  tensors (any device): the same points in the same order, with
  coordinates computed only at the crossings, where the reference
  materialises all 3 (R - 1) R^2 candidate points.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data import volumes as V

_RES_CACHE = {}


def resolution_for(name: str, n_points: int) -> int:
    """The grid resolution R that ``point_cloud_for`` extracts ``name`` at
    for a budget of ``n_points`` (memoised): crossings scale ~ c * R^2, with
    c estimated at R = 64 on the t = 0 field."""
    key = (name, n_points)
    if key not in _RES_CACHE:
        field, iso = V.make_volume(name, 64)
        f = field - iso
        c = sum(
            int((np.take(f, range(0, 63), axis=ax)
                 * np.take(f, range(1, 64), axis=ax) < 0).sum())
            for ax in range(3)
        )
        c = max(c, 1)
        _RES_CACHE[key] = int(np.clip(np.sqrt(n_points / c) * 64, 16, 1024))
    return _RES_CACHE[key]


def crossing_points(field: np.ndarray, iso: float) -> np.ndarray:
    """Every edge crossing of a (R, R, R) numpy field -> (n, 3) float32 in
    [0, 1]^3: axis-major, row-major within an axis."""
    R = field.shape[0]
    f = field - iso
    pts = []
    for ax in range(3):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[ax] = slice(0, R - 1)
        sl1[ax] = slice(1, R)
        a, b = f[tuple(sl0)], f[tuple(sl1)]
        cross = (a * b) < 0
        t = a / (a - b + 1e-30)
        idx = np.argwhere(cross).astype(np.float32)
        tt = t[cross][:, None]
        step = np.zeros((1, 3), np.float32)
        step[0, ax] = 1.0
        pts.append((idx + tt * step + 0.5) / R)
    return np.concatenate(pts).astype(np.float32)


def point_cloud_for(name: str, n_points: int, *, seed: int = 0,
                    t: float = 0.0):
    """Extract ~n_points isosurface points from the named analytic volume.

    -> (points (n, 3) float32, colors (n, 3) float32).  Deterministic.
    ``t`` samples the time-evolved field (``volumes.make_volume(..., t=t)``)
    at the SAME resolution R as t = 0 (``resolution_for``), so every
    timestep of a series extracts from an identical grid and point counts
    stay comparable across t.
    """
    R = resolution_for(name, n_points)
    pts = crossing_points(*V.make_volume(name, R, t=t))
    rng = np.random.default_rng(seed)
    if len(pts) > n_points:
        sel = rng.choice(len(pts), n_points, replace=False)
        pts = pts[sel]
    return pts, V.height_colors(pts)


def extract_isosurface(field: torch.Tensor, iso: float, *, max_points: int):
    """field (R, R, R) float32 tensor -> (points (max_points, 3) float32 in
    [0, 1]^3, count () int32), both on the field's device.

    The first ``max_points`` crossings in the reference's order (axis-major,
    row-major within an axis: ``jnp.nonzero``'s); ``count`` saturates at
    ``max_points`` and the rows past it repeat the first point (renderable
    padding; with no crossing at all, axis 0's candidate at the origin, as
    the reference pads)."""
    R = field.shape[0]
    f = field - iso
    total, pts = 0, []
    for ax in range(3):
        a = f.narrow(ax, 0, R - 1)
        b = f.narrow(ax, 1, R - 1)
        cross = (a * b) < 0
        total += int(cross.sum())
        room = max_points - sum(p.shape[0] for p in pts)
        if room <= 0:
            continue
        ijk = torch.nonzero(cross)[:room]                    # (n, 3) int64
        pts.append(_points_at(a, b, ijk, ax, R))
    got = torch.cat(pts)
    count = min(total, max_points)
    if count == 0:
        origin = torch.zeros((1, 3), dtype=torch.int64, device=f.device)
        first = _points_at(f.narrow(0, 0, R - 1), f.narrow(0, 1, R - 1),
                           origin, 0, R)
    else:
        first = got[:1]
    pad = first.expand(max_points - count, 3)
    return (torch.cat([got[:count], pad]),
            torch.tensor(count, dtype=torch.int32, device=f.device))


def _points_at(a, b, ijk, ax: int, R: int):
    """Crossing points of axis ``ax`` at grid corners ``ijk`` (n, 3):
    ``(ijk + t * e_ax + 0.5) / R`` with t = a / (a - b + 1e-30), float32."""
    i, j, k = ijk.unbind(1)
    av, bv = a[i, j, k], b[i, j, k]
    t = av / (av - bv + 1e-30)
    step = torch.zeros(3, dtype=torch.float32, device=a.device)
    step[ax] = 1.0
    return (ijk.to(torch.float32) + t[:, None] * step + 0.5) / R
