"""Single-device render path: project -> tile-assign -> gather -> kernel ->
untile -> composite.

Port of ``repro.core.render``, dense dispatch only: every tile carries the
same top-K list and the rasterizer runs one launch over all tiles (V*T for
a view batch).  The tiered (``k_tiers=``) dispatch and the coarse pre-cull
come with the training slice.

The reference vmaps projection and assignment over a view axis; here the
view axis is explicit (``project`` takes a batched camera) and assignment
loops over the views.  ``render_batch`` and ``assign_tables`` are the paths
the reference runs under ``jit`` / ``vmap``, so their sorted-assignment
budget follows the reference's traced rule (``exact_budget=False``; see
core/tiling.py); ``render`` follows its eager rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.cameras import Camera, select
from repro_torch.core.dtypes import cast_tables
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.projection import Splats2D, project
from repro_torch.core.tiling import (
    DEFAULT_ASSIGN_IMPL,
    SORTED_MIN_TILES,
    TileGrid,
    assign_tiles,
    auto_tile_budget,
    gather_features_at,
    resolve_assign_impl,
    splat_features,
    splat_tile_counts,
    tile_origins,
    untile_image,
)
from repro_torch.kernels.ops import rasterize_tiles, rasterize_tiles_batched


class RenderOut(NamedTuple):
    rgb: torch.Tensor          # (H, W, 3) or (V, H, W, 3), bg-composited
    coverage: torch.Tensor     # (H, W) / (V, H, W) alpha coverage in [0, 1]
    #: tiered renders only (dropped tiles past the tier caps); None on the
    #: dense path, the only one ported yet
    overflow: Optional[torch.Tensor] = None
    #: tile-ASSIGNMENT budget counter (scalar; (V,) for batched renders):
    #: bbox candidate slots dropped past the sorted path's budget.  Always
    #: 0 on the dense sweep.
    assign_overflow: Optional[torch.Tensor] = None


def _gather_feats(g: Gaussians, cam: Camera, grid: TileGrid, *, K: int,
                  block: int = 4096,
                  assign_impl: str = DEFAULT_ASSIGN_IMPL,
                  assign_budget: Optional[int] = None,
                  dtype_policy: str = "f32"):
    """project -> tile-assign -> per-tile feature gather for one view.
    -> (tile_feats (T, K, F), idx (T, K), score (T, K), assign_ov ())."""
    splats = project(g, cam)
    idx, score, assign_ov = assign_tiles(
        splats, grid, K=K, block=block, impl=assign_impl,
        tile_budget=assign_budget, return_overflow=True)
    feats = cast_tables(gather_features_at(splat_features(splats), idx,
                                           score), dtype_policy)
    return feats, idx, score, assign_ov


def _composite(img, bg):
    """(..., H, W, 4) kernel output -> RenderOut over a solid background."""
    cov = img[..., 3]
    rgb = img[..., :3] + (1.0 - cov[..., None]) * bg
    return RenderOut(rgb=rgb, coverage=cov)


def _view(splats: Splats2D, v: int) -> Splats2D:
    return Splats2D(*(f[v] for f in splats))


def _assign_views(splats: Splats2D, grid: TileGrid, *, K: int, block: int,
                  assign_impl: str, assign_budget: Optional[int]):
    """Per-view assignment of (V, N) splats under the traced budget rule ->
    (idx (V, T, K), score (V, T, K), assign_ov (V,))."""
    outs = [assign_tiles(_view(splats, v), grid, K=K, block=block,
                         impl=assign_impl, tile_budget=assign_budget,
                         return_overflow=True, exact_budget=False)
            for v in range(splats.depth.shape[0])]
    idx, score, ov = zip(*outs)
    return torch.stack(idx), torch.stack(score), torch.stack(ov)


def render(g: Gaussians, cam: Camera, grid: TileGrid, *, K: int = 64,
           impl: str = "auto", bg: float = 1.0,
           assign_impl: str = DEFAULT_ASSIGN_IMPL,
           assign_budget: Optional[int] = None,
           dtype_policy: str = "f32") -> RenderOut:
    """Full-image render of one camera with background composite (paper bg
    is white).  ``assign_impl``/``assign_budget`` pick the tile-assignment
    algorithm (see core.tiling.assign_tiles)."""
    feats, _, _, assign_ov = _gather_feats(
        g, cam, grid, K=K, assign_impl=assign_impl,
        assign_budget=assign_budget, dtype_policy=dtype_policy)
    tiles = rasterize_tiles(feats, tile_origins(grid, feats.device),
                            tile_h=grid.tile_h, tile_w=grid.tile_w, impl=impl)
    out = _composite(untile_image(tiles, grid), bg)
    return out._replace(assign_overflow=assign_ov)


def render_batch(g: Gaussians, cams: Camera, grid: TileGrid, *, K: int = 64,
                 impl: str = "auto", bg: float = 1.0,
                 assign_block: Optional[int] = None,
                 assign_impl: str = DEFAULT_ASSIGN_IMPL,
                 assign_budget: Optional[int] = None,
                 dtype_policy: str = "f32") -> RenderOut:
    """View-batched render: cams carries a leading V axis on view/fx/fy.
    Projection runs once over (V, N), assignment per view, and the
    rasterizer runs ONE flattened (V*T,) launch.  Returns rgb (V, H, W, 3),
    coverage (V, H, W) and assign_overflow (V,)."""
    V = cams.view.shape[0]
    block = assign_block or max(1024, 4096 // max(V, 1))
    splats = project(g, cams)                                  # (V, N)
    idx, score, assign_ov = _assign_views(
        splats, grid, K=K, block=block, assign_impl=assign_impl,
        assign_budget=assign_budget)
    feats = cast_tables(gather_features_at(splat_features(splats), idx,
                                           score), dtype_policy)
    tiles = rasterize_batched(feats, grid, impl=impl)
    return _composite(untile_image(tiles, grid), bg)._replace(
        assign_overflow=assign_ov)


def rasterize_batched(feats, grid: TileGrid, *, impl: str = "auto"):
    """(V, T, K, F) tile features -> (V, T, 4, th, tw), one launch."""
    return rasterize_tiles_batched(
        feats, tile_origins(grid, feats.device),
        tile_h=grid.tile_h, tile_w=grid.tile_w, impl=impl)


# ---------------------------------------------------------------------------
# Cache-aware entry points (serving): assignment tables as first-class values
# ---------------------------------------------------------------------------


def table_features(g: Gaussians, cams: Camera, idx, score, *,
                   dtype_policy: str = "f32"):
    """Per-tile kernel features of a view batch from a PRECOMPUTED
    assignment table: idx/score (V, T, K) -> (V, T, K, FEAT_DIM)."""
    feat = cast_tables(splat_features(project(g, cams)), dtype_policy)
    return gather_features_at(feat, idx, score)


def render_batch_tables(g: Gaussians, cams: Camera, grid: TileGrid,
                        idx, score, *, impl: str = "auto",
                        bg: float = 1.0,
                        dtype_policy: str = "f32") -> RenderOut:
    """View-batched render from a PRECOMPUTED assignment table.

    ``idx``/``score`` (V, T, K) are the tables ``assign_tables`` extracts.
    Projection still runs per view (it feeds the feature gather) but
    assignment is skipped; the kernel work is the same flattened (V*T,)
    launch as ``render_batch``.  The serving cache renders hits AND misses
    through here, which makes a hit bit-identical to its cold miss."""
    tiles = rasterize_batched(
        table_features(g, cams, idx, score, dtype_policy=dtype_policy),
        grid, impl=impl)
    return _composite(untile_image(tiles, grid), bg)


def assign_tables(g: Gaussians, cams: Camera, grid: TileGrid, K: int, *,
                  assign_impl: str = DEFAULT_ASSIGN_IMPL,
                  assign_budget: Optional[int] = None):
    """Assignment-TABLE extraction for a view batch: ``-> (idx (V, T, K),
    score (V, T, K), assign_ov (V,))`` — the eager counterpart of the
    reference's ``assign_tables_jit`` (traced budget rule)."""
    block = max(1024, 4096 // max(cams.view.shape[0], 1))
    return _assign_views(project(g, cams), grid, K=K, block=block,
                         assign_impl=assign_impl,
                         assign_budget=assign_budget)


def max_tile_count(g: Gaussians, cams: Camera, grid: TileGrid, *,
                   chunk: int = 8) -> int:
    """Host-side max per-splat bbox tile count over a WHOLE camera rig,
    probed ``chunk`` views at a time to bound the probe's footprint."""
    V = cams.view.shape[0]
    best = 0
    if g.means.shape[0] == 0:
        return best
    for s in range(0, V, chunk):
        views = torch.arange(s, min(s + chunk, V), device=cams.view.device)
        counts = splat_tile_counts(project(g, select(cams, views)), grid)
        best = max(best, int(counts.max()))
    return best


def resolve_assignment(g: Gaussians, cams: Camera, grid: TileGrid, *,
                       assign_impl: str = DEFAULT_ASSIGN_IMPL,
                       assign_budget: Optional[int] = None):
    """Host-side resolution of the tile-assignment knobs -> a concrete
    ``(impl, budget)`` pair.  When the sorted path is in play ("sorted"
    pinned, or "auto" on a >= SORTED_MIN_TILES grid) and no budget was
    given, probe the max per-splat bbox tile count over the whole rig and
    size a budget with slack (``auto_tile_budget``); then let
    ``resolve_assign_impl`` decide, demoting "auto" to the dense sweep when
    the budget is too fat for duplicate-and-sort to win."""
    candidate = (assign_impl == "sorted"
                 or (assign_impl == "auto"
                     and grid.n_tiles >= SORTED_MIN_TILES))
    if assign_budget is None and candidate:
        assign_budget = auto_tile_budget(max_tile_count(g, cams, grid),
                                         grid.n_tiles)
    impl = resolve_assign_impl(assign_impl, grid.n_tiles, assign_budget)
    return impl, (assign_budget if impl == "sorted" else None)
