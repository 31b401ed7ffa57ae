"""Spatial data partitioning with ghost cells (paper §II step 3).

The point cloud is split into ``n`` spatial partitions — one per compute node
(mesh "pod" axis entry) — on a regular grid whose per-axis bin edges are
*quantiles* of the point coordinates, so partitions are load-balanced by point
count even for skewed isosurfaces.  Points within ``ghost_width`` of a
neighbouring partition's boundary are replicated into that neighbour as
*ghost cells*; ghosts keep their source partition id in ``owner`` so the final
merge deduplicates them (core/merge.py).

A copy of ``repro.core.partition`` (numpy only; the port imports nothing of
the JAX package, so it keeps its own copy).  Host-level setup code (runs
once, before training): plain numpy,
deterministic given (points, n_parts, ghost_width).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of ``v`` (uint64) so consecutive input bits
    land 3 apart — one axis' lane of a 3-D Morton code."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_codes(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """(N, 3) -> (N,) uint64 Morton (Z-order) codes.

    Coordinates are quantised per axis to ``bits`` levels over the cloud's
    bounding box and bit-interleaved (x lowest lane).  Sorting by the code
    is a space-filling-curve order: rows adjacent in the sorted sequence
    are adjacent in space, so any contiguous row block is a spatially
    compact brick.  Deterministic given ``points`` (plain numpy, no RNG).
    """
    p = np.asarray(points, np.float64).reshape(-1, 3)
    if len(p) == 0:
        return np.zeros((0,), np.uint64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-12)
    top = (1 << bits) - 1
    q = np.minimum((p - lo) / span * top, top).astype(np.uint64)
    return (_spread_bits(q[:, 0])
            | (_spread_bits(q[:, 1]) << np.uint64(1))
            | (_spread_bits(q[:, 2]) << np.uint64(2)))


def spatial_order(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """(N, 3) -> (N,) argsort by Morton code (stable): the row order that
    makes equal row blocks spatially compact.

    This is the overlap-aware layout for the sparse splat exchange
    (core/distributed.py): the equal-capacity (P, N) gaussian stacks shard
    their N axis into contiguous row blocks over the mesh "part" axis, so
    Morton-ordering the rows turns each shard into a compact spatial brick
    — its splats project onto few screen-tile sub-windows, and the probed
    per-(src, dst) edge overlap genuinely shrinks as the shard count
    grows (instead of every edge seeing ~uniform overlap from spatially
    scrambled rows).
    """
    return np.argsort(morton_codes(points, bits), kind="stable")


def factor3(n: int) -> Tuple[int, int, int]:
    """Factor n into (nx, ny, nz) as close to cubic as possible."""
    best = (n, 1, 1)
    best_cost = float("inf")
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            c = m // b
            cost = max(a, b, c) / min(a, b, c)
            if cost < best_cost:
                best_cost = cost
                best = (a, b, c)
    return best


@dataclasses.dataclass(frozen=True)
class Partitioning:
    n_parts: int
    grid: Tuple[int, int, int]
    edges: Tuple[np.ndarray, np.ndarray, np.ndarray]  # per-axis bin edges
    ghost_width: float

    def cell_of(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) -> (N,) partition id."""
        ids = np.zeros(len(points), np.int64)
        mult = 1
        for ax, (g, e) in enumerate(zip(self.grid, self.edges)):
            ids += np.clip(np.searchsorted(e[1:-1], points[:, ax],
                                           side="right"), 0, g - 1) * mult
            mult *= g
        return ids


@dataclasses.dataclass
class PartitionData:
    """One partition's working set: owned points + ghosts from neighbours."""
    part_id: int
    points: np.ndarray      # (Np, 3) owned + ghost points
    colors: np.ndarray      # (Np, 3)
    owner: np.ndarray       # (Np,) source partition id (== part_id for owned)
    n_owned: int

    @property
    def n_ghost(self) -> int:
        return len(self.points) - self.n_owned


def make_partitioning(points: np.ndarray, n_parts: int,
                      ghost_width: float) -> Partitioning:
    grid = factor3(n_parts)
    edges = []
    for ax, g in enumerate(grid):
        qs = np.quantile(points[:, ax], np.linspace(0, 1, g + 1))
        qs[0] -= 1e-6
        qs[-1] += 1e-6
        # guard against degenerate (duplicate) quantiles
        for i in range(1, len(qs)):
            qs[i] = max(qs[i], qs[i - 1] + 1e-9)
        edges.append(qs)
    return Partitioning(n_parts, grid, tuple(edges), ghost_width)


def _neighbour_cells(part: Partitioning, points: np.ndarray,
                     ids: np.ndarray) -> List[np.ndarray]:
    """For each point, the set of *other* partitions whose slab it is within
    ghost_width of — computed per axis then combined over the <=3^3 offsets."""
    gw = part.ghost_width
    per_axis = []  # per axis: (N,) in {-1, 0, +1} masks for lo/hi proximity
    coords = []
    mult = 1
    for ax, (g, e) in enumerate(zip(part.grid, part.edges)):
        c = np.clip(np.searchsorted(e[1:-1], points[:, ax], side="right"),
                    0, g - 1)
        coords.append(c)
        lo = points[:, ax] - e[c] < gw          # close to lower edge
        hi = e[c + 1] - points[:, ax] < gw      # close to upper edge
        per_axis.append((lo & (c > 0), hi & (c < g - 1)))
        mult *= g
    out = []
    gx, gy, gz = part.grid
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                m = np.ones(len(points), bool)
                for ax, d in enumerate((dx, dy, dz)):
                    if d == -1:
                        m &= per_axis[ax][0]
                    elif d == 1:
                        m &= per_axis[ax][1]
                if not m.any():
                    continue
                nb = (
                    (coords[0] + dx)
                    + (coords[1] + dy) * gx
                    + (coords[2] + dz) * gx * gy
                )
                out.append((m, nb))
    return out


def partition_points(points: np.ndarray, colors: np.ndarray, n_parts: int,
                     *, ghost_width: float,
                     spatial_sort: bool = True) -> List[PartitionData]:
    """Split a point cloud into n partitions with ghost replication.

    Invariants (tested): every point is *owned* by exactly one partition;
    every ghost lies within ghost_width of its host partition's slab; the
    union of owned points over partitions is the input set.

    ``spatial_sort`` (default on) Morton-orders the rows WITHIN each
    partition's owned block and ghost block (``spatial_order``), so the
    contiguous row blocks the distributed layout shards over the mesh
    "part" axis are spatially compact — the overlap-aware layout the
    sparse splat exchange's per-edge budgets depend on.  It permutes rows
    only inside those two blocks: ownership, ghost membership and the
    owned-then-ghost layout are unchanged.  ``spatial_sort=False`` keeps
    the raw extraction order (spatially scrambled; every exchange edge
    then sees ~uniform overlap).
    """
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    part = make_partitioning(points, n_parts, ghost_width)
    ids = part.cell_of(points)

    ghosts: List[List[np.ndarray]] = [[] for _ in range(n_parts)]
    for mask, nb in _neighbour_cells(part, points, ids):
        for p in np.unique(nb[mask]):
            sel = mask & (nb == p)
            ghosts[int(p)].append(np.nonzero(sel)[0])

    out = []
    for p in range(n_parts):
        own = np.nonzero(ids == p)[0]
        gh = (np.unique(np.concatenate(ghosts[p]))
              if ghosts[p] else np.zeros((0,), np.int64))
        gh = gh[ids[gh] != p]                   # never ghost your own points
        if spatial_sort:
            own = own[spatial_order(points[own])]
            gh = gh[spatial_order(points[gh])]
        idx = np.concatenate([own, gh])
        out.append(PartitionData(
            part_id=p,
            points=points[idx],
            colors=colors[idx],
            owner=ids[idx].astype(np.int32),
            n_owned=len(own),
        ))
    return out, part
