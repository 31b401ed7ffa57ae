"""Tile assignment: fixed-K per-tile gaussian lists, and occupancy tiers.

Port of ``repro.core.tiling``.  Each tile keeps its top-K *front-most*
gaussians (conservative circle/rect overlap test), ordered (score desc,
splat index asc) with score = -depth — exactly the order front-to-back
compositing needs.  Two algorithms, bit-identical whenever the sorted
path's per-splat budget covers every splat's bbox tile count:

  "dense"   blockwise O(T * N) sweep with a running top-k merge;
  "sorted"  duplicate-and-sort scatter, O(N * B log(N * B)).

The reference packs its sorted-path key into uint32 and falls back to a
three-key variadic sort above 32 bits; here one int64 key
``tile << rank_bits | depth rank`` and one ``torch.sort`` serve every size,
with the same output.

Budgets: under ``jax.jit`` / ``vmap`` the reference sizes a missing sorted
budget as ``DEFAULT_TILE_BUDGET``, and exactly from the table only when
called on concrete arrays.  The port is eager, so callers state which rule
applies (``exact_budget``): the render paths the reference traces
(``render_batch``, ``assign_tables``) pass False; direct calls keep the
exact rule.

Occupancy tiers (``tile_occupancy``, ``tile_tiers``,
``bin_tiles_by_occupancy``, the cap sizers and ``TierSchedule``) are the
reference's, with host-side numpy where the reference reads concrete
values.

The coarse superblock pre-cull (``assign_tiles(coarse=sb)``, dense only)
culls each sb x sb tile superblock's candidates with one circle/rect pass
and runs the exact per-tile test against those survivors; the port loops
over blocks where the reference scans them, with the same ``(cand,
overflow)`` and the same ``(idx, score)`` on live slots.

Shape glossary: N splats, T tiles (grid.n_tiles), K per-tile list depth,
V views, S superblocks of the coarse pre-cull.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import as_numpy
from repro_torch.core.projection import Splats2D

NEG = -1e30

#: per-splat feature vector length fed to the rasterizer kernel
#: [mx, my, conicA, conicB, conicC, r, g, b, alpha, pad...]
FEAT_DIM = 16


class TileGrid(NamedTuple):
    """Static image/tile geometry: (height, width) pixels split into
    row-major (tile_h, tile_w) tiles — T = n_tiles = ny * nx."""
    width: int
    height: int
    tile_h: int = 8
    tile_w: int = 128

    @property
    def nx(self) -> int:
        return (self.width + self.tile_w - 1) // self.tile_w

    @property
    def ny(self) -> int:
        return (self.height + self.tile_h - 1) // self.tile_h

    @property
    def n_tiles(self) -> int:
        return self.nx * self.ny


def tile_bounds(grid: TileGrid, device):
    """Tile rects on ``device``: (T, 2) lo, (T, 2) hi in pixel coords
    (x, y), float32."""
    ty, tx = torch.meshgrid(torch.arange(grid.ny, device=device),
                            torch.arange(grid.nx, device=device),
                            indexing="ij")
    lo = torch.stack([tx.reshape(-1) * grid.tile_w,
                      ty.reshape(-1) * grid.tile_h], -1)
    hi = lo + torch.tensor([grid.tile_w, grid.tile_h], device=device)
    return lo.to(torch.float32), hi.to(torch.float32)


def tile_origins(grid: TileGrid, device):
    """(T, 2) float32 pixel coords of each tile's top-left corner (x, y),
    on ``device``."""
    lo, _ = tile_bounds(grid, device)
    return lo


def topk_by_score_then_index(cat_s, cat_i, K: int):
    """Top-K of (score, idx) pairs: score descending, splat index ascending.

    cat_s (..., C) float32 scores, cat_i (..., C) indices -> (..., K) of
    each.  The reference leans on ``lax.top_k`` keeping the lower position
    among equal scores; ``torch.topk`` promises no tie order, so the order
    is made explicit: a stable sort by index, then a stable sort by score.
    The selection is therefore a pure function of the (score, idx) set.
    """
    cat_i = cat_i.to(torch.int32)
    by_idx = torch.argsort(cat_i, dim=-1, stable=True)
    s = torch.gather(cat_s, -1, by_idx)
    i = torch.gather(cat_i, -1, by_idx)
    by_score = torch.argsort(s, dim=-1, descending=True, stable=True)
    sel = by_score[..., :K]
    return torch.gather(s, -1, sel), torch.gather(i, -1, sel)


# ---------------------------------------------------------------------------
# Coarse superblock pre-cull
# ---------------------------------------------------------------------------


def superblock_bounds(grid: TileGrid, sb: int, device):
    """Bounds of sb x sb tile superblocks on ``device``: (S, 2) lo / hi
    pixel rects, float32, row-major.  The last row / column may extend past
    the image: the coarse test is conservative."""
    sx = (grid.nx + sb - 1) // sb
    sy = (grid.ny + sb - 1) // sb
    syi, sxi = torch.meshgrid(torch.arange(sy, device=device),
                              torch.arange(sx, device=device), indexing="ij")
    lo = torch.stack([sxi.reshape(-1) * grid.tile_w * sb,
                      syi.reshape(-1) * grid.tile_h * sb], -1) \
        .to(torch.float32)
    hi = lo + torch.tensor([grid.tile_w * sb, grid.tile_h * sb],
                           dtype=torch.float32, device=device)
    return lo, hi


def coarse_candidates(mean2d, radius, valid, grid: TileGrid, *, sb: int,
                      budget: int, block: int = 4096):
    """Per-superblock candidate splat lists via one circle/rect pass.

    -> (cand (S, budget) int32, overflow () int32).  ``cand`` holds
    indices into the splat table in table order, N (one past the end) in
    the slots past a superblock's occupancy.  A superblock holding more
    than ``budget`` splats drops its HIGHEST-indexed ones (table order, not
    depth order); ``overflow`` counts exactly those dropped (superblock,
    splat) pairs, 0 when the cull is exact.  Blockwise over the splats:
    O(S * block) temporaries, each block's hits compacted to their columns
    with one cumsum and one scatter."""
    dev = mean2d.device
    lo, hi = superblock_bounds(grid, sb, dev)             # (S, 2)
    N, S = mean2d.shape[0], lo.shape[0]
    block = min(block, max(N, 1))
    count = torch.zeros((S,), dtype=torch.int64, device=dev)
    # overflow and non-hits land in scratch column ``budget``, cut below
    cand = torch.full((S, budget + 1), N, dtype=torch.int32, device=dev)
    for b0 in range(0, N, block):
        mx, my = mean2d[b0:b0 + block, 0], mean2d[b0:b0 + block, 1]
        rd = radius[b0:b0 + block]
        cx = torch.clamp(mx[None, :], lo[:, :1], hi[:, :1])   # (S, block)
        cy = torch.clamp(my[None, :], lo[:, 1:], hi[:, 1:])
        dx = mx[None, :] - cx
        dy = my[None, :] - cy
        hit = ((dx * dx + dy * dy) <= (rd * rd)[None, :]) \
            & valid[None, b0:b0 + block]
        pos = torch.where(hit, count[:, None] + torch.cumsum(hit, 1) - 1,
                          budget).clamp(max=budget)
        idx = torch.arange(b0, b0 + mx.shape[0], dtype=torch.int32,
                           device=dev)
        cand.scatter_(1, pos, idx.expand(S, -1))
        count += hit.sum(1)
    overflow = (count - budget).clamp(min=0).sum().to(torch.int32)
    return cand[:, :budget], overflow


def _coarse_budget(N: int, S: int, K: int, budget) -> int:
    """Resolve the per-superblock candidate budget (see assign_tiles)."""
    if budget is None:
        # 4x headroom over uniform splat -> superblock occupancy; below 8
        # superblocks the radius halo rivals a superblock: exact (N)
        budget = N if S < 8 else max(4 * K, -(-4 * N // S))
    budget = min(max(int(budget), K), N)
    budget = -(-budget // 128) * 128 if budget >= 128 else budget
    return min(budget, N)


def _assign_tiles_coarse(splats: Splats2D, grid: TileGrid, *, K: int,
                         block: int, sb: int, budget: int):
    """The exact circle/rect top-K restricted to coarse-pass survivors ->
    (idx (T, K), score (T, K), overflow ()), as ``assign_tiles``.  Work
    drops from O(T * N) to O(S * N + T * budget): each superblock's
    candidates are gathered once and its sb * sb tile slots tested against
    them, then scattered back to row-major tile order."""
    dev = splats.mean2d.device
    N = splats.mean2d.shape[0]
    sx = (grid.nx + sb - 1) // sb
    sy = (grid.ny + sb - 1) // sb
    S, sb2 = sx * sy, sb * sb
    cand, overflow = coarse_candidates(splats.mean2d, splats.radius,
                                       splats.valid, grid, sb=sb,
                                       budget=budget, block=block)
    M = cand.shape[1]
    cb = min(block, M)

    def take(arr, fill):
        # the sentinel N reads the appended fill row (an invalid splat)
        pad = arr.new_full((1,) + tuple(arr.shape[1:]), fill)
        return torch.cat([arr, pad])[cand.long()]          # (S, M, ...)

    mean_c = take(splats.mean2d, 0.0)
    rad_c = take(splats.radius, 0.0)
    depth_c = take(splats.depth, 1e30)
    valid_c = take(splats.valid, False)

    # tile-slot rects per superblock, (S, sb2, 2); slots past the image
    # edge are dead weight, dropped by the scatter-back
    syi, sxi = torch.meshgrid(torch.arange(sy, device=dev),
                              torch.arange(sx, device=dev), indexing="ij")
    jy, jx = torch.meshgrid(torch.arange(sb, device=dev),
                            torch.arange(sb, device=dev), indexing="ij")
    ty = syi.reshape(-1, 1) * sb + jy.reshape(-1)           # (S, sb2)
    tx = sxi.reshape(-1, 1) * sb + jx.reshape(-1)
    lo_sb = torch.stack([tx * grid.tile_w, ty * grid.tile_h], -1) \
        .to(torch.float32)
    hi_sb = lo_sb + torch.tensor([grid.tile_w, grid.tile_h],
                                 dtype=torch.float32, device=dev)

    top_s = torch.full((S, sb2, K), NEG, dtype=torch.float32, device=dev)
    top_i = torch.zeros((S, sb2, K), dtype=torch.int32, device=dev)
    for c0 in range(0, M, cb):
        mb = mean_c[:, c0:c0 + cb]                          # (S, cb, 2)
        rb, db = rad_c[:, c0:c0 + cb], depth_c[:, c0:c0 + cb]
        cx = torch.clamp(mb[:, None, :, 0], lo_sb[..., :1], hi_sb[..., :1])
        cy = torch.clamp(mb[:, None, :, 1], lo_sb[..., 1:], hi_sb[..., 1:])
        dx = mb[:, None, :, 0] - cx                         # (S, sb2, cb)
        dy = mb[:, None, :, 1] - cy
        hit = (dx * dx + dy * dy) <= (rb * rb)[:, None, :]
        hit = hit & valid_c[:, None, c0:c0 + cb]
        score = torch.where(hit, -db[:, None, :], NEG)
        ci = cand[:, None, c0:c0 + cb].expand(S, sb2, -1)
        top_s, top_i = topk_by_score_then_index(
            torch.cat([top_s, score], -1), torch.cat([top_i, ci], -1), K)

    # scatter back: tile t (row-major) lives at slot (sbid, (ty%sb)*sb+tx%sb)
    tyf, txf = torch.meshgrid(torch.arange(grid.ny, device=dev),
                              torch.arange(grid.nx, device=dev),
                              indexing="ij")
    pos = (((tyf // sb) * sx + txf // sb) * sb2
           + (tyf % sb) * sb + txf % sb).reshape(-1)        # (T,)
    score = top_s.reshape(S * sb2, K)[pos]
    idx = top_i.reshape(S * sb2, K)[pos]
    # empty slots (score NEG) carry a safe in-range index
    idx = torch.where(score > NEG / 2, idx, torch.zeros_like(idx))
    return idx, score, overflow


def assign_tiles(splats: Splats2D, grid: TileGrid, *, K: int = 64,
                 block: int = 4096, coarse: Optional[int] = None,
                 coarse_budget: Optional[int] = None,
                 return_overflow: bool = False,
                 impl: str = "dense", tile_budget: Optional[int] = None,
                 exact_budget: bool = True):
    """Top-K front-most gaussians per tile, for one view's (N,) splats.

    -> (idx (T, K) int32 into the splat table, score (T, K) float32; NEG
    marks empty slots, whose idx is 0), plus the () int32 count of
    candidates dropped past a budget when ``return_overflow`` (the sorted
    path's per-splat budget, or the coarse pre-cull's).  ``impl`` is
    "auto" | "dense" | "sorted" (see ``resolve_assign_impl``);
    ``exact_budget`` see the module docstring.

    ``coarse=sb`` (dense only: "sorted" ignores it) first culls sb x sb
    tile superblocks to candidate lists of ``coarse_budget`` splats (auto:
    N when there are fewer than 8 superblocks, else max(4K, ceil(4N/S)),
    rounded up to 128), then runs the exact test against those survivors.
    With a budget at or above every superblock's occupancy the result
    equals the dense sweep on live slots; past it the highest-INDEXED
    candidates drop and the counter says how many.  A resolved budget of N
    or more culls nothing, so the dense sweep runs directly.
    """
    if resolve_assign_impl(impl, grid.n_tiles, tile_budget) == "sorted":
        idx, score, ov = assign_tiles_sorted(
            splats, grid, K=K, tile_budget=tile_budget, return_overflow=True,
            exact_budget=exact_budget)
        return (idx, score, ov) if return_overflow else (idx, score)
    if coarse is not None and coarse > 1:
        N = splats.mean2d.shape[0]
        S = (-(-grid.nx // coarse)) * (-(-grid.ny // coarse))
        budget = _coarse_budget(N, S, K, coarse_budget) if N else 0
        if 0 < budget < N:
            idx, score, ov = _assign_tiles_coarse(
                splats, grid, K=K, block=block, sb=coarse, budget=budget)
            return (idx, score, ov) if return_overflow else (idx, score)
        # budget >= N (or an empty table): the dense sweep
    dev = splats.mean2d.device
    lo, hi = tile_bounds(grid, dev)                  # (T, 2)
    N = splats.mean2d.shape[0]
    block = min(block, max(N, K))
    T = grid.n_tiles
    top_s = torch.full((T, K), NEG, dtype=torch.float32, device=dev)
    top_i = torch.zeros((T, K), dtype=torch.int32, device=dev)
    for b0 in range(0, N, block):
        mb = splats.mean2d[b0:b0 + block]
        rb = splats.radius[b0:b0 + block]
        # circle/rect overlap: clamp center to rect, compare distance to
        # radius
        cx = torch.clamp(mb[None, :, 0], lo[:, :1], hi[:, :1])  # (T, block)
        cy = torch.clamp(mb[None, :, 1], lo[:, 1:], hi[:, 1:])
        dx = mb[None, :, 0] - cx
        dy = mb[None, :, 1] - cy
        hit = (dx * dx + dy * dy) <= (rb * rb)[None, :]
        hit = hit & splats.valid[None, b0:b0 + block]
        score = torch.where(hit, -splats.depth[None, b0:b0 + block], NEG)
        idx = torch.arange(b0, b0 + mb.shape[0], dtype=torch.int32,
                           device=dev).expand(T, -1)
        top_s, top_i = topk_by_score_then_index(
            torch.cat([top_s, score], 1), torch.cat([top_i, idx], 1), K)
    if return_overflow:
        return top_i, top_s, torch.zeros((), dtype=torch.int32, device=dev)
    return top_i, top_s


# ---------------------------------------------------------------------------
# Sort-based assignment (duplicate-and-sort scatter)
# ---------------------------------------------------------------------------


#: static per-splat tile budget the reference applies under tracing when no
#: budget is given (a 4x4-tile bbox neighbourhood)
DEFAULT_TILE_BUDGET = 16

#: assignment impl the render layers default to (``assign_impl=``)
DEFAULT_ASSIGN_IMPL = "auto"

#: "auto" crossover: grids with fewer flat tiles stay on the dense sweep
SORTED_MIN_TILES = 512

#: "auto" crossover, per-splat axis: sorted only while budget * ratio <= T
SORTED_BUDGET_RATIO = 20


def resolve_assign_impl(impl: str, n_tiles: int,
                        tile_budget: Optional[int] = None) -> str:
    """Resolve an ``assign_impl`` knob ("auto" | "dense" | "sorted").
    "auto" picks the sorted path only on a grid of >= SORTED_MIN_TILES
    tiles AND with a known per-splat budget under n_tiles /
    SORTED_BUDGET_RATIO; otherwise the always-exact dense sweep."""
    if impl == "auto":
        if n_tiles < SORTED_MIN_TILES or tile_budget is None \
                or tile_budget * SORTED_BUDGET_RATIO > n_tiles:
            return "dense"
        return "sorted"
    if impl not in ("dense", "sorted"):
        raise ValueError(f"unknown assignment impl {impl!r}; expected "
                         "'auto', 'dense' or 'sorted'")
    return impl


def resolve_tile_budget(n_tiles: int, tile_budget: Optional[int]) -> int:
    """Static per-splat budget: auto = min(T, DEFAULT_TILE_BUDGET); clamped
    to [1, T]."""
    b = DEFAULT_TILE_BUDGET if tile_budget is None else int(tile_budget)
    return max(1, min(b, max(n_tiles, 1)))


def _bbox_bounds(mx, my, rad, grid: TileGrid):
    """Clipped tile-coordinate bbox of each splat's circle: (x0, x1, y0, y1)
    int32, batch-polymorphic.  The low edges use ceil-1 (not floor) so a
    circle exactly tangent to a tile boundary still covers the tile the
    dense sweep's clamp test counts as a hit."""
    tw = float(grid.tile_w)
    th = float(grid.tile_h)
    i32 = torch.int32
    x0 = torch.clamp(torch.ceil((mx - rad) / tw).to(i32) - 1, 0, grid.nx - 1)
    x1 = torch.clamp(torch.floor((mx + rad) / tw).to(i32), 0, grid.nx - 1)
    y0 = torch.clamp(torch.ceil((my - rad) / th).to(i32) - 1, 0, grid.ny - 1)
    y1 = torch.clamp(torch.floor((my + rad) / th).to(i32), 0, grid.ny - 1)
    return x0, x1, y0, y1


def splat_tile_counts(splats: Splats2D, grid: TileGrid):
    """(..., N) int32 per-splat bbox candidate-tile counts — what the
    sorted path's budget must cover for bit-exactness."""
    x0, x1, y0, y1 = _bbox_bounds(splats.mean2d[..., 0],
                                  splats.mean2d[..., 1], splats.radius, grid)
    cnt = torch.clamp(x1 - x0 + 1, min=0) * torch.clamp(y1 - y0 + 1, min=0)
    return torch.where(splats.valid, cnt, 0).to(torch.int32)


def auto_tile_budget(max_count, n_tiles: int, *, slack: float = 1.5,
                     round_to: int = 16) -> int:
    """Concrete max per-splat bbox count -> static sorted-path budget:
    scaled by ``slack``, rounded up to ``round_to``, clamped to
    [1, n_tiles]."""
    b = int(np.ceil(max(int(max_count), 1) * slack))
    b = -(-b // round_to) * round_to
    return max(1, min(b, max(int(n_tiles), 1)))


def window_overlap_mask(mx, my, rad, valid, grid: TileGrid, *, t0,
                        n_local: int, t_end=None):
    """Which splats' clipped tile bboxes can touch the contiguous row-major
    flat-tile window ``[t0, t0 + n_local)``: the sparse exchange's
    per-(source, destination) packing predicate.

    mx/my/rad/valid (..., N); ``t0`` an int or a (W,) sequence of window
    offsets (which prepends a window axis) -> bool (..., N) (or (W, ...,
    N)).  A window's tiles live in rows ``[t0 // nx, (t0 + n_local - 1) //
    nx]``; a splat whose clipped bbox rows meet that span is a superset of
    the splats whose circles hit a window tile.  ``t_end`` clips every
    window at an exclusive flat-tile bound (``[t0, min(t0 + n_local,
    t_end))``; a window starting at or past it matches nothing): the
    padded sub-windows of a strip that does not divide."""
    _, _, y0, y1 = _bbox_bounds(mx, my, rad, grid)
    t0 = torch.as_tensor(t0, dtype=torch.int32, device=mx.device)
    if t_end is None:
        lim, live = t0 + n_local, None
    else:
        t_end = torch.as_tensor(t_end, dtype=torch.int32, device=mx.device)
        lim, live = torch.minimum(t0 + n_local, t_end), t0 < t_end
    r0 = torch.div(t0, grid.nx, rounding_mode="floor")
    r1 = torch.div(lim - 1, grid.nx, rounding_mode="floor")
    if t0.dim():
        shape = tuple(t0.shape) + (1,) * y0.dim()
        r0, r1 = r0.reshape(shape), r1.reshape(shape)
        if live is not None:
            live = live.reshape(shape)
    out = valid & (y0 <= r1) & (y1 >= r0)
    return out if live is None else out & live


def grow_tile_budget(budget: int, n_tiles: int, *, growth: float = 2.0,
                     round_to: int = 16) -> int:
    """Geometric growth for a per-splat tile budget that reported overflow,
    clamped to [1, n_tiles]."""
    b = int(np.ceil(max(int(budget), 1) * growth))
    b = -(-b // round_to) * round_to
    return max(1, min(b, max(int(n_tiles), 1)))


def _expand_splat_tiles(mx, my, rad, valid, grid: TileGrid, *,
                        budget: int, t0: Optional[int] = None,
                        n_local: Optional[int] = None):
    """Expand one (N,) splat table into per-splat candidate tiles over a
    static ``budget`` of bbox tile slots (row-major within the bbox).

    ``t0`` is the flat-tile offset of a LOCAL window of ``n_local``
    row-major tiles (None/None = the full grid).  -> (tile (N, B) int32
    LOCAL ids with n_local as the miss/pad sentinel, overflow () int32
    bbox slots dropped past the budget — 0 proves exactness)."""
    Tl = grid.n_tiles if n_local is None else n_local
    tw = float(grid.tile_w)
    th = float(grid.tile_h)
    x0, x1, y0, y1 = _bbox_bounds(mx, my, rad, grid)
    if t0 is not None:
        # clamp the bbox rows to the window's row span
        y0 = torch.clamp(y0, min=t0 // grid.nx)
        y1 = torch.clamp(y1, max=(t0 + Tl - 1) // grid.nx)
    bw = torch.clamp(x1 - x0 + 1, min=1)
    nt = torch.where(valid,
                     torch.clamp(x1 - x0 + 1, min=0)
                     * torch.clamp(y1 - y0 + 1, min=0), 0)
    jj = torch.arange(budget, dtype=torch.int32, device=mx.device)[None, :]
    inb = jj < nt[:, None]                            # (N, B)
    ty = y0[:, None] + torch.div(jj, bw[:, None], rounding_mode="floor")
    tx = x0[:, None] + torch.remainder(jj, bw[:, None])
    # exact circle/rect test — identical arithmetic to the dense sweep
    lox = tx.to(torch.float32) * tw
    loy = ty.to(torch.float32) * th
    cx = torch.clamp(mx[:, None], lox, lox + tw)
    cy = torch.clamp(my[:, None], loy, loy + th)
    dx = mx[:, None] - cx
    dy = my[:, None] - cy
    hit = inb & (dx * dx + dy * dy <= (rad * rad)[:, None])
    flat = ty * grid.nx + tx
    if t0 is not None:
        flat = flat - t0
        hit &= (flat >= 0) & (flat < Tl)
    tile = torch.where(hit, flat, Tl).to(torch.int32)
    overflow = torch.clamp(nt - budget, min=0).sum().to(torch.int32)
    return tile, overflow


def _splat_depth_ranks(depth):
    """Stable (depth asc, splat idx asc) ranking of a (N,) depth table,
    ordered by the uint32 bit pattern of the float32 depth as the
    reference does (a float sort would place negative depths elsewhere;
    those splats are invalid and emit no candidates either way).

    -> (rank_of (N,) int64 rank per original splat, perm (N,) int64
    original index per rank)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    perm = torch.sort(bits, stable=True).indices
    rank_of = torch.empty_like(perm)
    rank_of[perm] = torch.arange(perm.shape[0], device=perm.device)
    return rank_of, perm


def _segment_topk(tile, rank_of, perm, depth, *, n_tiles: int, K: int):
    """Per-tile first K of the candidate set via one int64 sort.

    tile (N, B) LOCAL ids (sentinel ``n_tiles``).  Each hit packs into the
    key ``tile << rank_bits | rank``: ascending keys are exactly the
    (tile, depth, splat idx) order, and the key decodes back to the splat.
    Ranks past K fall off; empty slots carry (idx 0, score NEG) —
    bit-identical to the dense sweep."""
    N = tile.shape[0]
    dev = tile.device
    rank_bits = max(1, (N - 1).bit_length())
    if n_tiles.bit_length() + rank_bits > 62:
        raise ValueError(f"{n_tiles} tiles x {N} splats overflow the int64 "
                         "assignment key")
    hit = tile < n_tiles
    keys = (tile[hit].to(torch.int64) << rank_bits) \
        | rank_of[:, None].expand_as(tile)[hit]
    skeys = torch.sort(keys).values                   # (M,) hits only
    M = skeys.shape[0]
    idx = torch.zeros((n_tiles, K), dtype=torch.int32, device=dev)
    score = torch.full((n_tiles, K), NEG, dtype=torch.float32, device=dev)
    if M == 0:
        return idx, score
    bounds = torch.searchsorted(
        skeys, torch.arange(n_tiles + 1, dtype=torch.int64,
                            device=dev) << rank_bits)
    pos = bounds[:n_tiles, None] + torch.arange(K, device=dev)[None, :]
    live = pos < bounds[1:, None]                     # within my tile's run
    key_at = skeys[torch.clamp(pos, max=M - 1)]
    r = torch.clamp(key_at & ((1 << rank_bits) - 1), max=N - 1)
    src = perm[r]                                     # original splat index
    idx = torch.where(live, src, 0).to(torch.int32)
    score = torch.where(live, -depth[src], NEG)
    return idx, score


def sorted_assign_window(mx, my, rad, valid, depth, grid: TileGrid, *,
                         K: int, t0: Optional[int] = None,
                         n_local: Optional[int] = None,
                         tile_budget: Optional[int] = None,
                         exact_budget: bool = True):
    """Sort-based assignment of one raw (N,) splat table over a LOCAL tile
    window (None/None = the full grid).  -> (idx (Tl, K) int32, score
    (Tl, K), overflow () int32), with ``assign_tiles``'s slot semantics.

    ``tile_budget=None`` sizes the budget exactly from this table (no
    drops) when ``exact_budget``, else as DEFAULT_TILE_BUDGET — the
    reference's rule under tracing."""
    Tl = grid.n_tiles if n_local is None else int(n_local)
    N = mx.shape[0]
    dev = mx.device
    if N == 0:
        return (torch.zeros((Tl, K), dtype=torch.int32, device=dev),
                torch.full((Tl, K), NEG, dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    if tile_budget is None and exact_budget:
        x0, x1, y0, y1 = _bbox_bounds(mx, my, rad, grid)
        cnt = torch.clamp(x1 - x0 + 1, min=0) * torch.clamp(y1 - y0 + 1,
                                                            min=0)
        tile_budget = int(torch.where(valid, cnt, 0).max())
    budget = resolve_tile_budget(grid.n_tiles, tile_budget)
    tile, overflow = _expand_splat_tiles(
        mx, my, rad, valid, grid, budget=budget, t0=t0, n_local=Tl)
    rank_of, perm = _splat_depth_ranks(depth)
    idx, score = _segment_topk(tile, rank_of, perm, depth, n_tiles=Tl, K=K)
    return idx, score, overflow


def assign_tiles_sorted(splats: Splats2D, grid: TileGrid, *, K: int = 64,
                        tile_budget: Optional[int] = None,
                        return_overflow: bool = False,
                        exact_budget: bool = True):
    """Sort-based top-K assignment: same contract as ``assign_tiles``.
    Bit-identical to the dense sweep whenever the budget covers every
    splat's bbox tile count; with ``return_overflow=True`` a third () int32
    counts bbox slots dropped past the budget."""
    idx, score, overflow = sorted_assign_window(
        splats.mean2d[..., 0], splats.mean2d[..., 1], splats.radius,
        splats.valid, splats.depth, grid, K=K, tile_budget=tile_budget,
        exact_budget=exact_budget)
    return (idx, score, overflow) if return_overflow else (idx, score)


# ---------------------------------------------------------------------------
# Variable-K occupancy binning (tiered rasterization)
# ---------------------------------------------------------------------------


class TierPlan(NamedTuple):
    """Static-shape dispatch schedule for tiered rasterization.

    tile_ids  per tier i: (..., cap_i) int32 flat tile ids compacted to the
              front; slots past ``counts[..., i]`` hold M (the one-past-
              the-end sentinel, M = the flat tile count).
    counts    (..., n_tiers) int32: tiles actually placed per tier.
    overflow  (...) int32: tiles that fit no tier because every cap from
              their desired tier upward was full -- dropped from
              rasterization (they render as background).
    """
    tile_ids: Tuple[torch.Tensor, ...]
    counts: torch.Tensor
    overflow: torch.Tensor


def tile_occupancy(score):
    """(..., T, K) assignment scores -> (..., T) int32 live-entry counts."""
    return (score > NEG / 2).sum(dim=-1).to(torch.int32)


def tile_tiers(occupancy, k_tiers: Sequence[int]):
    """Per-tile tier index: the smallest tier whose K covers the occupancy.

    occupancy (..., T) int32 -> (..., T) int32 in [-1, n_tiers).  Empty
    tiles get -1; tiles deeper than the top tier land in the top tier."""
    kt = torch.tensor(tuple(int(k) for k in k_tiers), dtype=torch.int32,
                      device=occupancy.device)
    covered = occupancy[..., None] <= kt               # (..., T, n_tiers)
    tier = torch.argmax(covered.to(torch.int8), dim=-1).to(torch.int32)
    tier = torch.where(covered.any(dim=-1), tier, len(kt) - 1)
    return torch.where(occupancy > 0, tier, -1).to(torch.int32)


def bin_tiles_by_occupancy(occupancy, k_tiers: Sequence[int],
                           tier_caps: Sequence[int]) -> TierPlan:
    """Bin flat tiles into K-tiers with static per-tier capacities.

    occupancy (..., M) int32 (leading axes bin independently, as the
    reference's ``vmap`` of it does).  Tiles fill their desired tier in
    flat-tile-id order; a tile whose tier is full promotes to the next
    larger tier, and tiles that fall off the top count in ``overflow``.
    Empty tiles are placed in no tier."""
    k_tiers = tuple(int(k) for k in k_tiers)
    tier_caps = tuple(int(c) for c in tier_caps)
    if len(tier_caps) != len(k_tiers):
        raise ValueError(f"{len(k_tiers)} tiers but {len(tier_caps)} caps")
    if any(b <= a for a, b in zip(k_tiers, k_tiers[1:])):
        raise ValueError(f"k_tiers must be strictly increasing: {k_tiers}")
    M = occupancy.shape[-1]
    lead = tuple(occupancy.shape[:-1])
    dev = occupancy.device
    tier = tile_tiers(occupancy, k_tiers)
    ids = torch.arange(M, dtype=torch.int32, device=dev).expand(lead + (M,))
    tile_ids, counts = [], []
    carry = torch.zeros(lead + (M,), dtype=torch.bool, device=dev)
    for i, cap in enumerate(tier_caps):
        want = (tier == i) | carry
        rank = torch.cumsum(want.to(torch.int32), dim=-1) - 1
        take = want & (rank < cap)
        pos = torch.where(take, torch.clamp(rank, max=cap), cap)
        buf = torch.full(lead + (cap + 1,), M, dtype=torch.int32, device=dev)
        buf.scatter_(-1, pos.long(), torch.where(take, ids, M))
        tile_ids.append(buf[..., :cap])
        counts.append(torch.clamp(want.sum(dim=-1), max=cap).to(torch.int32))
        carry = want & ~take
    return TierPlan(tile_ids=tuple(tile_ids),
                    counts=torch.stack(counts, dim=-1),
                    overflow=carry.sum(dim=-1).to(torch.int32))


def _tier_counts(occupancy, k_tiers: Sequence[int]):
    """Concrete (..., T) occupancy -> (per-tier worst-slice counts, max
    occ): counts[i] = max over leading slices of the tiles whose DESIRED
    tier is i -- what the caps must cover."""
    occ = as_numpy(occupancy)
    if occ.size == 0:
        return [0] * len(tuple(k_tiers)), 0
    occ = occ.reshape(-1, occ.shape[-1])
    tiers = tile_tiers(torch.from_numpy(np.ascontiguousarray(occ)),
                       k_tiers).numpy()
    counts = [int((tiers == i).sum(axis=-1).max())
              for i in range(len(tuple(k_tiers)))]
    return counts, int(occ.max())


def caps_from_tier_counts(counts: Sequence[int], *, slack: float = 1.0,
                          round_to: int = 8, limit: int) -> Tuple[int, ...]:
    """Per-tier tile counts -> static caps: scale by ``slack``, round up to
    ``round_to``, clamp at ``limit`` (the flat tile count of the binning
    domain).  Zero counts keep cap 0 (no launch)."""
    caps = []
    for c in counts:
        c = int(c)
        if c:
            c = int(np.ceil(c * slack))
            c = min(-(-c // round_to) * round_to, int(limit))
        caps.append(c)
    return tuple(caps)


def auto_tier_caps(occupancy, k_tiers: Sequence[int], *, slack: float = 1.0,
                   round_to: int = 8) -> Tuple[int, ...]:
    """Host-side cap sizing from concrete (..., T) occupancy counts: caps
    covering the worst slice, scaled by ``slack``, rounded up to
    ``round_to``."""
    occ = as_numpy(occupancy)
    counts, _ = _tier_counts(occ, k_tiers)
    return caps_from_tier_counts(counts, slack=slack, round_to=round_to,
                                 limit=occ.shape[-1] if occ.size else 0)


class TierSchedule:
    """Telemetry-driven (k_tiers, tier_caps) picker for tiered training,
    and the serving K ladder.

      probe(occupancy)   concrete (..., T) occupancy measured at ``kmax``
          -> re-sized caps (cap 0 for unoccupied tiers); ``trim=True``
          also trims the ladder to the occupied prefix.
      note_overflow(ov, n_tiles)   a step's dropped-tile counter grows
          every cap by ``growth`` (clamped at ``n_tiles``); True when the
          caps changed.
      state_dict / load_state / from_state   a JSON snapshot, identical to
          the reference's, so a schedule moves between the two packages.
    """

    def __init__(self, k_tiers: Sequence[int] = (8, 32, 128), *,
                 slack: float = 1.25, round_to: int = 8,
                 growth: float = 2.0, trim: bool = False):
        ladder = tuple(int(k) for k in k_tiers)
        if not ladder or any(b <= a for a, b in zip(ladder, ladder[1:])):
            raise ValueError("k_tiers must be a non-empty strictly "
                             f"increasing ladder: {ladder}")
        self.ladder = ladder             # full ladder (probe depth = max)
        self.slack = float(slack)
        self.round_to = int(round_to)
        self.growth = float(growth)
        self.trim = bool(trim)
        self.k_tiers: Tuple[int, ...] = ladder   # active tiers
        self.tier_caps: Optional[Tuple[int, ...]] = None  # None until probe

    @property
    def kmax(self) -> int:
        """Assignment depth probes must use."""
        return self.ladder[-1]

    def probe(self, occupancy):
        """Re-pick (k_tiers, tier_caps) from concrete (..., T) occupancy
        measured at ``self.kmax``."""
        occ = as_numpy(occupancy)
        counts, max_occ = _tier_counts(occ, self.ladder)
        return self.probe_counts(counts, max_occ,
                                 n_tiles=occ.shape[-1] if occ.size else 0)

    def probe_counts(self, tier_counts, max_occ, *, n_tiles: int):
        """Re-pick (k_tiers, tier_caps) from reduced telemetry: per-tier
        worst-domain tile counts over the full ladder, the max occupancy,
        and ``n_tiles`` (the cap clamp)."""
        counts = [int(c) for c in np.asarray(as_numpy(tier_counts)).reshape(-1)]
        if len(counts) != len(self.ladder):
            raise ValueError(
                f"probe_counts got {len(counts)} tier counts for the "
                f"{len(self.ladder)}-tier ladder {self.ladder}; counts must "
                "be measured over the schedule's FULL ladder")
        max_occ = int(max_occ)
        active = self.ladder
        if self.trim:
            for i, k in enumerate(self.ladder):
                if max_occ <= k and k < self.ladder[-1]:
                    active = self.ladder[: i + 1]
                    break
        self.k_tiers = active
        self.tier_caps = caps_from_tier_counts(
            counts[: len(active)], slack=self.slack, round_to=self.round_to,
            limit=n_tiles)
        return self.k_tiers, self.tier_caps

    def note_overflow(self, overflow, n_tiles: int) -> bool:
        """Grow every cap by ``growth`` (clamped at ``n_tiles``) when the
        counter is positive; True when the caps changed."""
        ov = int(np.asarray(as_numpy(overflow)).sum())
        if ov <= 0 or self.tier_caps is None:
            return False
        grown = tuple(
            min(int(n_tiles), max(self.round_to,
                                  int(np.ceil(c * self.growth))))
            for c in self.tier_caps)
        if grown == self.tier_caps:
            return False
        self.tier_caps = grown
        return True

    def state_dict(self) -> dict:
        """JSON-able snapshot (ladder, knobs, active tiers, caps)."""
        return {
            "ladder": list(self.ladder),
            "slack": self.slack,
            "round_to": self.round_to,
            "growth": self.growth,
            "trim": self.trim,
            "k_tiers": list(self.k_tiers),
            "tier_caps": None if self.tier_caps is None
            else list(self.tier_caps),
        }

    def load_state(self, state: dict) -> "TierSchedule":
        """Restore a ``state_dict`` snapshot in place and return self."""
        ladder = tuple(int(k) for k in state["ladder"])
        if not ladder or any(b <= a for a, b in zip(ladder, ladder[1:])):
            raise ValueError(f"checkpointed ladder is invalid: {ladder}")
        self.ladder = ladder
        self.slack = float(state["slack"])
        self.round_to = int(state["round_to"])
        self.growth = float(state["growth"])
        self.trim = bool(state["trim"])
        self.k_tiers = tuple(int(k) for k in state["k_tiers"])
        caps = state["tier_caps"]
        self.tier_caps = None if caps is None else tuple(int(c) for c in caps)
        return self

    @classmethod
    def from_state(cls, state: dict) -> "TierSchedule":
        """Rebuild a schedule from a ``state_dict`` snapshot."""
        return cls(state["ladder"]).load_state(state)

    def __repr__(self):
        return (f"TierSchedule(k_tiers={self.k_tiers}, "
                f"tier_caps={self.tier_caps}, ladder={self.ladder})")


# ---------------------------------------------------------------------------
# Features, gather, untile
# ---------------------------------------------------------------------------


def splat_features(splats: Splats2D):
    """Per-splat kernel features: (..., N, FEAT_DIM) rows [mx, my, conicA,
    conicB, conicC, r, g, b, alpha, 0-pad]; invalid splats get alpha=0."""
    a, b, c = splats.cov2d[..., 0], splats.cov2d[..., 1], splats.cov2d[..., 2]
    det = torch.clamp(a * c - b * b, min=1e-12)
    conic = torch.stack([c / det, -b / det, a / det], -1)
    alpha = torch.where(splats.valid, splats.alpha, 0.0)
    feat = torch.cat([splats.mean2d, conic, splats.rgb, alpha[..., None]],
                     dim=-1)                                  # (..., 9)
    pad = feat.new_zeros(feat.shape[:-1] + (FEAT_DIM - feat.shape[-1],))
    return torch.cat([feat, pad], dim=-1)


def gather_features_at(feat, idx, score):
    """Gather rows of a feature table into per-tile lists.

    feat (N, F) with idx/score (..., K), or view-batched feat (V, N, F) with
    idx/score (V, ..., K) -> (..., K, F).  Empty slots (score NEG) get
    alpha=0 -> contribute nothing."""
    idx = idx.long()
    if feat.dim() == 3:
        V, N, F = feat.shape
        offs = torch.arange(V, device=idx.device) * N
        idx = idx + offs.reshape((V,) + (1,) * (idx.dim() - 1))
        feat = feat.reshape(V * N, F)
    tile_feat = feat[idx]                                    # (..., K, F)
    live = score > NEG / 2
    alpha = torch.where(live, tile_feat[..., 8], 0.0)
    return torch.cat([tile_feat[..., :8], alpha[..., None],
                      tile_feat[..., 9:]], dim=-1)


def untile_image(tiles, grid: TileGrid):
    """(..., T, 4, th, tw) kernel output -> (..., H, W, 4) image (cropped to
    the grid size)."""
    th, tw = grid.tile_h, grid.tile_w
    lead = tiles.shape[:-4]
    n = len(lead)
    img = tiles.reshape(lead + (grid.ny, grid.nx, 4, th, tw))
    img = img.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    img = img.reshape(lead + (grid.ny * th, grid.nx * tw, 4))
    return img[..., : grid.height, : grid.width, :]


def tile_image(img, grid: TileGrid):
    """(..., H, W, C) image -> (..., T, C, th, tw) tile layout (the inverse
    of ``untile_image``; pixels past the image edge are zero-filled)."""
    th, tw = grid.tile_h, grid.tile_w
    lead = img.shape[:-3]
    n = len(lead)
    H, W, C = img.shape[-3:]
    img = torch.nn.functional.pad(
        img, (0, 0, 0, grid.nx * tw - W, 0, grid.ny * th - H))
    t = img.reshape(lead + (grid.ny, th, grid.nx, tw, C))
    t = t.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return t.reshape(lead + (grid.n_tiles, C, th, tw))


# ---------------------------------------------------------------------------
# Serving-cache helpers: pose-bucket keys + assignment-table reuse
# ---------------------------------------------------------------------------

#: default pose-quantization resolution for the serving assignment cache
POSE_BINS = 1024.0


def quantize_pose(view, fx, fy, *, bins: float = POSE_BINS):
    """Quantize one camera pose onto a lattice of bucket edge ``1/bins``.

    -> ``(key, (view', fx', fy'))``: ``key`` is a hashable tuple of int
    bucket coordinates (16 view-matrix entries + the two focals, focals
    scaled by 1/1024), the primed triple the canonical pose as float32
    numpy values.  Host-side numpy, identical to the reference; ``view`` /
    ``fx`` / ``fy`` may be tensors or arrays."""
    v = as_numpy(view).astype(np.float64).reshape(4, 4)
    qv = np.rint(v * bins)
    qf = np.rint(np.asarray([float(as_numpy(fx)), float(as_numpy(fy))],
                            np.float64) * (bins / 1024.0))
    key = tuple(int(x) for x in qv.ravel()) + tuple(int(x) for x in qf)
    canon_view = (qv / bins).astype(np.float32)
    canon_f = (qf * (1024.0 / bins)).astype(np.float32)
    return key, (canon_view, canon_f[0], canon_f[1])


def slice_table(idx, score, k: int):
    """Depth-``k`` prefix of a cached ``(..., K)`` assignment table — the
    depth-``k`` assignment, bit for bit (the table is in the total order
    score desc, index asc)."""
    if k > idx.shape[-1]:
        raise ValueError(
            f"slice_table: k={k} exceeds cached table depth {idx.shape[-1]}")
    return idx[..., :k], score[..., :k]
