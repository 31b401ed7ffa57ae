"""The benchmark's inputs, made from ``--seed``: the isosurface points of a
configuration's field, the training rig, and the serving poses of a
traffic mix.

Points come from the configuration's point source (``source``), the one
entry that the train and serve runs, the output check and the control go
through.  A configuration may bring its own in ``scenes/<config>.py``,
found by name beside ``configs/<config>.json``, ``traffic/``,
``limits/``, ``metrics/`` and its CPU twin ``tests/small/<config>.json``:
a module with

- ``points(cfg, seed, device) -> (points, colours, rows, count)``, the
  program's side (it may import ``repro_torch``, inside the function):
  the points of the rows kept, on ``device``, their colours
  (``fields.height_colors``, as the reference colours them), the rows,
  and the crossings counted;
- ``reference_points(cfg, device)`` -> every crossing, in the order
  ``rows`` index: the reference's side, which imports nothing of the
  program (checked when the file is loaded).  A field too large to make
  whole is made and extracted slab by slab (``fields.crossings_by_slab``).

Without such a file the source is the dense one (``DENSE``): the field is
made whole on the device (``fields.make_field``), the program's extraction
finds its crossings, and ``n_points`` of them are drawn from the seed (all
of them where there are fewer: then the seed changes nothing a training
cell reads).  The reference extracts again from the same field, and the
check holds the program's points against its rows.

Poses (``ViewerPoses``): one general generator for closed-loop viewers,
parameterised by the traffic file: ``"fresh"`` draws every pose anew on a
sphere round the scene, ``"ring"`` walks each viewer round its own ring of
``ring_size`` poses.  Distances cycle through ``distance_levels`` values
spread over ``distance`` (in scene radii), so every seed offers the same
mix of distances in another order.
"""

from __future__ import annotations

import ast
import importlib.util
import re
import types
from pathlib import Path
from typing import Iterator, List

import numpy as np
import torch

from gsbench import fields, reference

#: the program's top-level module name, which a reference side may not load
PROGRAM = ("repro_torch",)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one named stream of ``seed``."""
    return np.random.default_rng([abs(int(seed))] + list(stream))


def select_rows(count: int, n_points: int, seed: int) -> np.ndarray:
    """The crossings kept: ``n_points`` of ``count`` drawn from the seed
    without replacement (all, in order, where there are not more)."""
    if count <= n_points:
        return np.arange(count)
    return rng(seed, 0).choice(count, n_points, replace=False)


def dense_points(cfg: dict, seed: int, device):
    """The dense source's program side -> (points (n, 3) float32 tensor on
    ``device``, colours (n, 3), rows kept, crossings counted): the whole
    field, the program's ``extract_isosurface``; the field is freed before
    this returns."""
    from repro_torch.data.isosurface import extract_isosurface
    field = fields.make_field(cfg["field"], cfg["resolution"], device)
    cap = int(cfg["max_crossings"])
    pts, count = extract_isosurface(field, float(cfg["iso"]), max_points=cap)
    del field
    count = int(count)
    if count >= cap:
        raise ValueError(f"{count} crossings fill the extraction cap {cap}: "
                         "raise max_crossings in the configuration")
    rows = select_rows(count, int(cfg["points"]), seed)
    pts = pts[torch.from_numpy(rows).to(pts.device)]
    return pts, fields.height_colors(pts), rows, count


def dense_reference_points(cfg: dict, device) -> torch.Tensor:
    """The dense source's reference side: every crossing of the whole
    field by the reference's own extraction."""
    field = fields.make_field(cfg["field"], cfg["resolution"], device)
    return fields.crossings(field, float(cfg["iso"]))


DENSE = types.SimpleNamespace(points=dense_points,
                              reference_points=dense_reference_points)


def _imported(node) -> Iterator[str]:
    """Top-level names of the modules that ``node``'s statements import."""
    for n in ast.walk(node):
        if isinstance(n, ast.Import):
            for a in n.names:
                yield a.name.split(".")[0]
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.module.split(".")[0]


def reference_imports(path: Path) -> List[str]:
    """The program's modules that a scene file's reference side imports:
    at module level, in ``reference_points``, or in a function of the file
    that it calls, directly or through another."""
    tree = ast.parse(Path(path).read_text(), str(path))
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}
    names = set()
    for n in tree.body:
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            names.update(_imported(n))
    todo, seen = ["reference_points"], set()
    while todo:
        name = todo.pop()
        if name in seen or name not in defs:
            continue
        seen.add(name)
        names.update(_imported(defs[name]))
        todo.extend(n.id for n in ast.walk(defs[name])
                    if isinstance(n, ast.Name) and n.id in defs)
    return sorted(names & set(PROGRAM))


def source(cell=None):
    """The point source of ``cell``'s configuration: the module
    ``scenes/<config>.py`` of the cell's benchmark where it has one, else
    ``DENSE`` (also without a cell).  A scene file whose reference side
    imports the program is refused."""
    if cell is None:
        return DENSE
    path = Path(cell.bench) / "scenes" / f"{cell.spec['config']}.py"
    if not path.exists():
        return DENSE
    bad = reference_imports(path)
    if bad:
        raise ImportError(f"{path}: the reference side imports the program "
                          f"({', '.join(bad)})")
    spec = importlib.util.spec_from_file_location(
        "gsbench_scene_" + re.sub(r"\W", "_", cell.spec["config"]), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
