"""Single-device render path: project -> tile-assign -> gather -> kernel ->
untile -> composite.

Port of ``repro.core.render``.  Two rasterizer dispatch modes:

  dense (K=)        every tile carries the same top-K list; one launch over
                    all tiles (V*T for a view batch).
  tiered (k_tiers=) tiles are binned by occupancy into K-tiers; each
                    non-empty tier gets its own launch at its own K, and the
                    tier outputs scatter back into the full tile image.
                    Exact against dense at K = k_tiers[-1] whenever the
                    tier caps cover the occupancy histogram.

The reference vmaps projection and assignment over a view axis; here the
view axis is explicit (``project`` takes a batched camera) and assignment
loops over the views, without autograd (the indices are discrete: the
reference stop-gradients them).  ``render_batch``, ``assign_tables`` and
``view_occupancy`` are the paths the reference runs under ``jit`` /
``vmap``, so their sorted-assignment budget follows the reference's traced
rule (``exact_budget=False``; see core/tiling.py); ``render`` and
``render_tiles`` follow its eager rule.  The coarse pre-cull is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.cameras import Camera, select
from repro_torch.core.dtypes import cast_tables
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.projection import Splats2D, project
from repro_torch.core.tiling import (
    DEFAULT_ASSIGN_IMPL,
    NEG,
    SORTED_MIN_TILES,
    TileGrid,
    assign_tiles,
    auto_tier_caps,
    auto_tile_budget,
    bin_tiles_by_occupancy,
    gather_features_at,
    resolve_assign_impl,
    splat_features,
    splat_tile_counts,
    tile_occupancy,
    tile_origins,
    untile_image,
)
from repro_torch.kernels.ops import (rasterize_tiles, rasterize_tiles_batched,
                                     rasterize_tiles_tiered)


class RenderOut(NamedTuple):
    rgb: torch.Tensor          # (H, W, 3) or (V, H, W, 3), bg-composited
    coverage: torch.Tensor     # (H, W) / (V, H, W) alpha coverage in [0, 1]
    #: tiered renders only: tiles dropped because every tier cap from their
    #: desired tier upward was full (scalar, or (V,) for batched renders);
    #: None on the dense path
    overflow: Optional[torch.Tensor] = None
    #: tile-ASSIGNMENT budget counter (scalar; (V,) for batched renders):
    #: bbox candidate slots dropped past the sorted path's budget.  Always
    #: 0 on the dense sweep.
    assign_overflow: Optional[torch.Tensor] = None


def _assign(splats: Splats2D, grid: TileGrid, **kw):
    """``assign_tiles`` without autograd: the indices are discrete (the
    reference stop-gradients them), and the float temporaries of the sweep
    need no graph."""
    with torch.no_grad():
        return assign_tiles(Splats2D(*(f.detach() for f in splats)), grid,
                            return_overflow=True, **kw)


def _gather_feats(g: Gaussians, cam: Camera, grid: TileGrid, *, K: int,
                  block: int = 4096,
                  assign_impl: str = DEFAULT_ASSIGN_IMPL,
                  assign_budget: Optional[int] = None,
                  dtype_policy: str = "f32"):
    """project -> tile-assign -> per-tile feature gather for one view.
    -> (tile_feats (T, K, F), idx (T, K), score (T, K), assign_ov ())."""
    splats = project(g, cam)
    idx, score, assign_ov = _assign(splats, grid, K=K, block=block,
                                    impl=assign_impl,
                                    tile_budget=assign_budget)
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
    outs = [_assign(_view(splats, v), grid, K=K, block=block,
                    impl=assign_impl, tile_budget=assign_budget,
                    exact_budget=False)
            for v in range(splats.depth.shape[0])]
    idx, score, ov = zip(*outs)
    return torch.stack(idx), torch.stack(score), torch.stack(ov)


# ---------------------------------------------------------------------------
# Tiered (variable-K) dispatch
# ---------------------------------------------------------------------------


def _take_rows(arr, ids, fill):
    """Rows ``ids`` (V, cap) of a per-view (V, T, ...) table, or of a shared
    (T, ...) table, with ``fill`` where the id is the sentinel T ->
    (V, cap, ...)."""
    shared = arr.dim() == ids.dim()
    if shared:
        arr = arr[None]
    pad = arr.new_full(arr.shape[:1] + (1,) + arr.shape[2:], fill)
    arr = torch.cat([arr, pad], dim=1)
    if shared:
        return arr[0][ids.long()]
    v = torch.arange(arr.shape[0], device=ids.device)[:, None]
    return arr[v, ids.long()]


def tier_tables(feat, idx, score, grid: TileGrid, *, k_tiers, tier_caps):
    """Bin each view's tiles into the K-tiers (shared static caps) and
    gather each tier's compacted kernel inputs, flattened over the views.

    feat (V, N, F) differentiable feature table; idx/score (V, T, Kmax) ->
    (per tier: feats (V * cap_i, K_i, F), origins (V * cap_i, 2), flat ids
    (V * cap_i,) into the (V * T,) tile image with V * T for padding; the
    TierPlan with per-view counts/overflow)."""
    V, T = score.shape[0], grid.n_tiles
    plan = bin_tiles_by_occupancy(tile_occupancy(score), k_tiers, tier_caps)
    origins = tile_origins(grid, feat.device)
    offs = torch.arange(V, dtype=torch.int32, device=feat.device)[:, None] * T
    tier_feats, tier_origins, flat_ids = [], [], []
    for k, ids in zip(k_tiers, plan.tile_ids):       # ids (V, cap_i)
        cap = ids.shape[1]
        idx_k = _take_rows(idx[:, :, :k], ids, 0)    # (V, cap, k)
        sc_k = _take_rows(score[:, :, :k], ids, NEG)
        tf = gather_features_at(feat, idx_k, sc_k)   # (V, cap, k, F)
        tier_feats.append(tf.reshape((V * cap,) + tuple(tf.shape[2:])))
        tier_origins.append(_take_rows(origins, ids, 0.0).reshape(V * cap, 2))
        flat_ids.append(torch.where(ids < T, ids + offs, V * T).reshape(-1))
    return tier_feats, tier_origins, flat_ids, plan


def _tiered_tiles_batched(feat, idx, score, grid: TileGrid, *, k_tiers,
                          tier_caps, impl: str):
    """View-batched tiered dispatch: ``tier_tables``, then ONE launch per
    tier over the flattened (V * cap_i,) tier tables.
    -> (tiles (V, T, 4, th, tw), plan with per-view counts/overflow)."""
    V, T = score.shape[0], grid.n_tiles
    tier_feats, tier_origins, flat_ids, plan = tier_tables(
        feat, idx, score, grid, k_tiers=k_tiers, tier_caps=tier_caps)
    tiles = rasterize_tiles_tiered(tier_feats, tier_origins, flat_ids, V * T,
                                   tile_h=grid.tile_h, tile_w=grid.tile_w,
                                   impl=impl)
    return tiles.reshape(V, T, 4, grid.tile_h, grid.tile_w), plan


def _tiered_tiles(feat, idx, score, grid: TileGrid, *, k_tiers, tier_caps,
                  impl: str):
    """Single-view tiered dispatch: feat (N, F); idx/score (T, Kmax) ->
    (tiles (T, 4, th, tw), plan with scalar counts/overflow) -- the batched
    dispatch at V = 1."""
    tiles, plan = _tiered_tiles_batched(feat[None], idx[None], score[None],
                                        grid, k_tiers=k_tiers,
                                        tier_caps=tier_caps, impl=impl)
    return tiles[0], type(plan)(tuple(i[0] for i in plan.tile_ids),
                                plan.counts[0], plan.overflow[0])


def _resolve_tiers(k_tiers, tier_caps, score):
    """Static (k_tiers, tier_caps) tuples; caps auto-sized from the
    concrete occupancy when not given."""
    k_tiers = tuple(int(k) for k in k_tiers)
    if tier_caps is None:
        tier_caps = auto_tier_caps(tile_occupancy(score), k_tiers)
    return k_tiers, tuple(int(c) for c in tier_caps)


def _render_tiles_tiered(g, cam, grid, *, impl, k_tiers, tier_caps,
                         assign_impl: str = DEFAULT_ASSIGN_IMPL,
                         assign_budget: Optional[int] = None,
                         dtype_policy: str = "f32"):
    splats = project(g, cam)
    idx, score, assign_ov = _assign(splats, grid, K=tuple(k_tiers)[-1],
                                    impl=assign_impl,
                                    tile_budget=assign_budget)
    k_tiers, tier_caps = _resolve_tiers(k_tiers, tier_caps, score)
    # the bf16 policy casts the (N, F) feature TABLE, as the reference does
    feat = cast_tables(splat_features(splats), dtype_policy)
    tiles, plan = _tiered_tiles(feat, idx, score, grid, k_tiers=k_tiers,
                                tier_caps=tier_caps, impl=impl)
    return tiles, idx, score, plan, assign_ov


# ---------------------------------------------------------------------------
# Public render entry points
# ---------------------------------------------------------------------------


def render_tiles(g: Gaussians, cam: Camera, grid: TileGrid, *, K: int = 64,
                 impl: str = "auto",
                 k_tiers: Optional[Sequence[int]] = None,
                 tier_caps: Optional[Sequence[int]] = None,
                 assign_impl: str = DEFAULT_ASSIGN_IMPL,
                 assign_budget: Optional[int] = None,
                 dtype_policy: str = "f32"):
    """-> (tiles (T, 4, th, tw), idx (T, K'), score (T, K')).

    Differentiable w.r.t. the gaussians.  With ``k_tiers`` the assignment
    runs at K' = k_tiers[-1] and the dispatch is tiered; ``K`` is then
    ignored."""
    if k_tiers is None:
        feats, idx, score, _ = _gather_feats(
            g, cam, grid, K=K, assign_impl=assign_impl,
            assign_budget=assign_budget, dtype_policy=dtype_policy)
        tiles = rasterize_tiles(feats, tile_origins(grid, feats.device),
                                tile_h=grid.tile_h, tile_w=grid.tile_w,
                                impl=impl)
        return tiles, idx, score
    tiles, idx, score, _, _ = _render_tiles_tiered(
        g, cam, grid, impl=impl, k_tiers=k_tiers, tier_caps=tier_caps,
        assign_impl=assign_impl, assign_budget=assign_budget,
        dtype_policy=dtype_policy)
    return tiles, idx, score


def render(g: Gaussians, cam: Camera, grid: TileGrid, *, K: int = 64,
           impl: str = "auto", bg: float = 1.0,
           k_tiers: Optional[Sequence[int]] = None,
           tier_caps: Optional[Sequence[int]] = None,
           assign_impl: str = DEFAULT_ASSIGN_IMPL,
           assign_budget: Optional[int] = None,
           dtype_policy: str = "f32") -> RenderOut:
    """Full-image render of one camera with background composite (paper bg
    is white).  ``k_tiers`` switches to occupancy-tiered rasterization (K
    is then ignored; ``tier_caps`` None sizes the caps from this scene) and
    fills ``RenderOut.overflow``.  ``assign_impl``/``assign_budget`` pick
    the tile-assignment algorithm (see core.tiling.assign_tiles)."""
    if k_tiers is None:
        feats, _, _, assign_ov = _gather_feats(
            g, cam, grid, K=K, assign_impl=assign_impl,
            assign_budget=assign_budget, dtype_policy=dtype_policy)
        tiles = rasterize_tiles(feats, tile_origins(grid, feats.device),
                                tile_h=grid.tile_h, tile_w=grid.tile_w,
                                impl=impl)
        out = _composite(untile_image(tiles, grid), bg)
        return out._replace(assign_overflow=assign_ov)
    tiles, _, _, plan, assign_ov = _render_tiles_tiered(
        g, cam, grid, impl=impl, k_tiers=k_tiers, tier_caps=tier_caps,
        assign_impl=assign_impl, assign_budget=assign_budget,
        dtype_policy=dtype_policy)
    out = _composite(untile_image(tiles, grid), bg)
    return out._replace(overflow=plan.overflow, assign_overflow=assign_ov)


def render_batch(g: Gaussians, cams: Camera, grid: TileGrid, *, K: int = 64,
                 impl: str = "auto", bg: float = 1.0,
                 assign_block: Optional[int] = None,
                 k_tiers: Optional[Sequence[int]] = None,
                 tier_caps: Optional[Sequence[int]] = None,
                 assign_impl: str = DEFAULT_ASSIGN_IMPL,
                 assign_budget: Optional[int] = None,
                 dtype_policy: str = "f32") -> RenderOut:
    """View-batched render: cams carries a leading V axis on view/fx/fy.
    Projection runs once over (V, N), assignment per view, and the
    rasterizer runs ONE flattened (V*T,) launch -- or, with ``k_tiers``,
    one flattened (V * cap_i,) launch per tier, each view binned on its own
    under shared caps (``RenderOut.overflow`` is then (V,)).  Returns rgb
    (V, H, W, 3), coverage (V, H, W) and assign_overflow (V,)."""
    V = cams.view.shape[0]
    block = assign_block or max(1024, 4096 // max(V, 1))
    splats = project(g, cams)                                  # (V, N)
    Kq = K if k_tiers is None else tuple(k_tiers)[-1]
    idx, score, assign_ov = _assign_views(
        splats, grid, K=Kq, block=block, assign_impl=assign_impl,
        assign_budget=assign_budget)
    if k_tiers is None:
        feats = cast_tables(gather_features_at(splat_features(splats), idx,
                                               score), dtype_policy)
        tiles = rasterize_batched(feats, grid, impl=impl)
        return _composite(untile_image(tiles, grid), bg)._replace(
            assign_overflow=assign_ov)
    k_tiers, tier_caps = _resolve_tiers(k_tiers, tier_caps, score)
    feat = cast_tables(splat_features(splats), dtype_policy)
    tiles, plan = _tiered_tiles_batched(feat, idx, score, grid,
                                        k_tiers=k_tiers, tier_caps=tier_caps,
                                        impl=impl)
    return _composite(untile_image(tiles, grid), bg)._replace(
        overflow=plan.overflow, assign_overflow=assign_ov)


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
    with torch.no_grad():
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
        with torch.no_grad():
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


def view_occupancy(g: Gaussians, cams: Camera, grid: TileGrid, *, K: int,
                   assign_block: Optional[int] = None,
                   assign_impl: str = DEFAULT_ASSIGN_IMPL,
                   assign_budget: Optional[int] = None):
    """(V, T) int32 per-view tile occupancy at assignment depth K (the
    traced budget rule, as the reference's jitted probe runs it)."""
    V = cams.view.shape[0]
    block = assign_block or max(1024, 4096 // max(V, 1))
    with torch.no_grad():
        _, score, _ = _assign_views(project(g, cams), grid, K=K, block=block,
                                    assign_impl=assign_impl,
                                    assign_budget=assign_budget)
    return tile_occupancy(score)


#: the standard occupancy probe for tier-cap sizing (the input of
#: ``TierSchedule.probe``), called with the same assignment impl and budget
#: as the step it sizes caps for: the eager counterpart of the reference's
#: ``occupancy_probe_jit(grid, K, None, assign_impl, assign_budget)(g, cams)``
occupancy_probe = view_occupancy
