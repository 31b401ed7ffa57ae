"""Isosurface point clouds for the analytic volumes (host-side numpy).

Port of ``repro.data.isosurface.point_cloud_for``: marching-cubes-style
*edge-crossing* extraction — for every grid edge along x/y/z where the field
crosses the iso value, emit the linearly-interpolated crossing point.  The
code is the reference's numpy host code, unchanged, so both packages seed
their Gaussians from bit-identical point clouds.  (The reference's jitted
fixed-capacity ``extract_isosurface`` is not on the serving path and is not
ported yet.)
"""

from __future__ import annotations

import numpy as np

from repro_torch.data import volumes as V

_RES_CACHE = {}


def point_cloud_for(name: str, n_points: int, *, seed: int = 0,
                    t: float = 0.0):
    """Extract ~n_points isosurface points from the named analytic volume.

    -> (points (n, 3) float32, colors (n, 3) float32).  Deterministic.
    Crossing count scales ~ R^2 x surface complexity; we search R once per
    (name, n_points) and memoise.  ``t`` samples the time-evolved field
    (``volumes.make_volume(..., t=t)``) at the SAME cached resolution R —
    the R search always probes t=0, so every timestep of a series extracts
    from an identical grid and point counts stay comparable across t.
    """
    key = (name, n_points)
    if key not in _RES_CACHE:
        # surface area heuristic: crossings ~ c * R^2; estimate c at R=64
        field, iso = V.make_volume(name, 64)
        f = field - iso
        c = sum(
            int((np.take(f, range(0, 63), axis=ax)
                 * np.take(f, range(1, 64), axis=ax) < 0).sum())
            for ax in range(3)
        )
        c = max(c, 1)
        R = int(np.clip(np.sqrt(n_points / c) * 64, 16, 1024))
        _RES_CACHE[key] = R
    R = _RES_CACHE[key]
    field, iso = V.make_volume(name, R, t=t)
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
    pts = np.concatenate(pts).astype(np.float32)
    rng = np.random.default_rng(seed)
    if len(pts) > n_points:
        sel = rng.choice(len(pts), n_points, replace=False)
        pts = pts[sel]
    return pts, V.height_colors(pts)
