"""The benchmark's inputs, made from ``--seed``: the isosurface points of a
configuration's field, the training rig, and the serving poses of a
traffic mix.

Points: the field is made on the device (``fields.make_field``), the
program's extraction finds its crossings, and ``n_points`` of them are
drawn from the seed (all of them where there are fewer: then the seed
changes nothing a training cell reads).  Both sides get
the same rows: the reference extracts again from the same field and checks
the program's points against its own.

Poses (``ViewerPoses``): one general generator for closed-loop viewers,
parameterised by the traffic file: ``"fresh"`` draws every pose anew on a
sphere round the scene, ``"ring"`` walks each viewer round its own ring of
``ring_size`` poses.  Distances cycle through ``distance_levels`` values
spread over ``distance`` (in scene radii), so every seed offers the same
mix of distances in another order.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from gsbench import fields, reference


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one named stream of ``seed``."""
    return np.random.default_rng([abs(int(seed))] + list(stream))


def select_rows(count: int, n_points: int, seed: int) -> np.ndarray:
    """The crossings kept: ``n_points`` of ``count`` drawn from the seed
    without replacement (all, in order, where there are not more)."""
    if count <= n_points:
        return np.arange(count)
    return rng(seed, 0).choice(count, n_points, replace=False)


def points_for(cfg: dict, seed: int, device, extract):
    """-> (points (n, 3) float32 tensor on ``device``, colours (n, 3), rows
    kept, crossings counted).  ``extract(field, iso, max_points=)`` is the
    program's extraction; the field is freed before this returns."""
    field = fields.make_field(cfg["field"], cfg["resolution"], device)
    cap = int(cfg["max_crossings"])
    pts, count = extract(field, float(cfg["iso"]), max_points=cap)
    del field
    count = int(count)
    if count >= cap:
        raise ValueError(f"{count} crossings fill the extraction cap {cap}: "
                         "raise max_crossings in the configuration")
    rows = select_rows(count, int(cfg["points"]), seed)
    pts = pts[torch.from_numpy(rows).to(pts.device)]
    return pts, fields.height_colors(pts), rows, count


def frame(points: np.ndarray):
    """Scene centre (bbox middle, float64), extent (bbox diagonal) and
    radius (farthest point from the centre)."""
    p = np.asarray(points, np.float64)
    center = 0.5 * (p.max(0) + p.min(0))
    extent = float(np.linalg.norm(np.asarray(points, np.float32).max(0)
                                  - np.asarray(points, np.float32).min(0)))
    radius = float(np.linalg.norm(p - center, axis=-1).max())
    return center, extent, radius


def train_views(n_views: int, center, extent: float):
    """The training rig, an orbit at 1.6 x half the extent, in its own
    order for every seed (the trainer sizes its tier caps on the first two
    views of a lap, and a step's memory follows the views before it) ->
    (n_views, 4, 4) float32 numpy."""
    radius = 1.6 * extent / 2 + 1e-3
    return reference.orbit_views(n_views, center, radius)


class ViewerPoses:
    """Eye positions of closed-loop viewers, drawn from a traffic mix's
    parameters and the seed.  ``next(v)`` -> the (4, 4) float32 view
    matrix of viewer v's next request."""

    def __init__(self, traffic: dict, center, radius: float, seed: int,
                 stream: int = 2):
        self.t = traffic
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)
        self.viewers = int(traffic["viewers"])
        lo, hi = traffic["distance"]
        self.levels = np.linspace(lo, hi, int(traffic["distance_levels"]))
        self.gen = rng(seed, stream)
        self.count = [0] * self.viewers
        if traffic["poses"] == "ring":
            n = self.viewers
            self.elev = np.linspace(-0.7, 0.7, n) if n > 1 else np.zeros(1)
            self.phase = self.gen.uniform(0, 2 * np.pi, n)
        elif traffic["poses"] != "fresh":
            raise ValueError(f"unknown poses {traffic['poses']!r}")

    def _eye(self, z: float, phi: float, d: float) -> np.ndarray:
        r = np.sqrt(max(1 - z * z, 1e-9))
        return self.center + d * self.radius * np.array(
            [r * np.cos(phi), r * np.sin(phi), z])

    def next(self, v: int) -> np.ndarray:
        k = self.count[v]
        self.count[v] += 1
        if self.t["poses"] == "ring":
            n = int(self.t["ring_size"])
            d = self.levels[v % len(self.levels)]
            phi = self.phase[v] + 2 * np.pi * (k % n) / n
            eye = self._eye(self.elev[v], phi, d)
        else:
            d = self.levels[(k + v) % len(self.levels)]
            z = self.gen.uniform(-0.95, 0.95)
            phi = self.gen.uniform(0, 2 * np.pi)
            eye = self._eye(z, phi, d)
        return reference.look_at(eye, self.center).astype(np.float32)

    def probe(self, n: int) -> Iterator[np.ndarray]:
        """``n`` poses of this mix's distances for sizing the assignment,
        the nearest first (drawn on their own stream)."""
        gen = rng(0, 3)
        for i in range(n):
            d = self.levels[i % len(self.levels)]
            eye = self._eye(gen.uniform(-0.95, 0.95),
                            gen.uniform(0, 2 * np.pi), d)
            yield reference.look_at(eye, self.center).astype(np.float32)
