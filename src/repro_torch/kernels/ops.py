"""Public entry points for the rasterizer (port of ``repro.kernels.ops``).

``rasterize_tiles(feats, origins, tile_h=, tile_w=, impl=)``:

  impl="cuda"   the hand-written CUDA kernel (kernels/rasterize.py); CUDA
                tensors only
  impl="ref"    the plain PyTorch version (kernels/ref.py); CPU tensors only
  impl="auto"   "cuda" for CUDA tensors, "ref" for CPU tensors

No path falls back from the kernel to the plain version: on a CUDA tensor
the kernel launches or the call raises.  On CUDA tensors the forward goes
through a ``torch.autograd.Function`` whose backward is the CUDA
``rasterize_bwd`` kernel; on CPU tensors autograd differentiates the plain
version.

  rasterize_tiles          one (T,) launch at a single K
  rasterize_tiles_batched  view-batched: (V, T) flattened to one (V*T,)
                           launch
  rasterize_tiles_tiered   variable-K: one launch per non-empty occupancy
                           tier, scattered back into the flat tile image
"""

from __future__ import annotations

import torch

from repro_torch.kernels import rasterize as rk
from repro_torch.kernels import ref as ref_impl

IMPLS = ("auto", "ref", "cuda")


class _RasterizeCUDA(torch.autograd.Function):
    """The CUDA kernel pair: ``rasterize_fwd`` forward, ``rasterize_bwd``
    backward.  Origins get a zero gradient and the feature gradient comes
    back in the input's dtype (``repro.kernels.ops._pallas_bwd``)."""

    @staticmethod
    def forward(ctx, feats, origins, tile_h: int, tile_w: int):
        out = rk.rasterize_fwd(feats, origins, tile_h=tile_h, tile_w=tile_w)
        ctx.save_for_backward(feats, origins, out)
        ctx.tile = (tile_h, tile_w)
        return out

    @staticmethod
    def backward(ctx, gout):
        feats, origins, out = ctx.saved_tensors
        tile_h, tile_w = ctx.tile
        gfeats = rk.rasterize_bwd(feats, origins, out, gout.contiguous(),
                                  tile_h=tile_h, tile_w=tile_w)
        gorig = torch.zeros_like(origins) if ctx.needs_input_grad[1] \
            else None
        return gfeats.to(feats.dtype), gorig, None, None


def resolve_impl(impl: str, feats: torch.Tensor) -> str:
    """"auto" -> "cuda" for a CUDA tensor, "ref" for a CPU tensor."""
    if impl not in IMPLS:
        raise ValueError(f"unknown rasterizer impl {impl!r}; expected one "
                         f"of {IMPLS}")
    if impl != "auto":
        return impl
    return "cuda" if feats.is_cuda else "ref"


def rasterize_tiles(feats, origins, *, tile_h: int, tile_w: int,
                    impl: str = "auto"):
    """feats (T, K, F) -> (T, 4, th, tw) [r, g, b, coverage].

    Mixed-precision boundary: feature blocks may arrive in a reduced
    storage dtype (core.dtypes); they are promoted to float32 here, the one
    funnel every impl shares, and the output is always float32."""
    feats = feats.to(torch.float32).contiguous()
    origins = origins.to(torch.float32).contiguous()
    impl = resolve_impl(impl, feats)
    if impl == "cuda":
        if not feats.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors; got "
                             f"{feats.device}")
        return _RasterizeCUDA.apply(feats, origins, tile_h, tile_w)
    if feats.is_cuda:
        raise ValueError("impl='ref' is the plain version for CPU tensors; "
                         "on a CUDA tensor use impl='cuda' (or call "
                         "kernels.ref directly to compare)")
    return ref_impl.rasterize_tiles_ref(feats, origins, tile_h=tile_h,
                                        tile_w=tile_w)


def rasterize_tiles_batched(feats, origins, *, tile_h: int, tile_w: int,
                            impl: str = "auto"):
    """View-batched entry point: feats (V, T, K, F) -> (V, T, 4, th, tw).

    origins may be (T, 2) (shared rig geometry) or (V, T, 2).  The V and T
    axes are flattened into one (V*T,) launch and unflattened afterwards;
    the same as V independent ``rasterize_tiles`` calls."""
    V, T, K, F = feats.shape
    if origins.dim() == 2:
        origins = origins[None].expand((V,) + tuple(origins.shape))
    out = rasterize_tiles(
        feats.reshape(V * T, K, F), origins.reshape(V * T, 2),
        tile_h=tile_h, tile_w=tile_w, impl=impl)
    return out.reshape(V, T, 4, tile_h, tile_w)


def rasterize_tiles_tiered(tier_feats, tier_origins, tier_ids, n_tiles: int,
                           *, tile_h: int, tile_w: int, impl: str = "auto"):
    """Variable-K dispatch: one kernel launch per non-empty occupancy tier.

    tier_feats    per tier i: (cap_i, K_i, F) compacted feature tables, each
                  at its own K_i.
    tier_origins  per tier i: (cap_i, 2) tile origins aligned with them.
    tier_ids      per tier i: (cap_i,) flat tile ids
                  (``TierPlan.tile_ids``); slots holding the sentinel
                  ``n_tiles`` are padding and are dropped by the scatter.
    n_tiles       M, the flat tile count of the full image.

    -> (M, 4, th, tw).  Tiles in no tier come back as exact zeros.  A tier
    of cap 0 is skipped (no launch); every other tier launches once, as
    the reference's static schedule does.  Differentiable w.r.t. every
    tier table: the scatter writes into one spare row that takes the
    sentinel slots and is cut off, so its transpose routes zeros to the
    padding slots.
    """
    out = torch.zeros((n_tiles + 1, 4, tile_h, tile_w), dtype=torch.float32,
                      device=tier_feats[0].device)
    for feats, origins, ids in zip(tier_feats, tier_origins, tier_ids):
        if feats.shape[0] == 0:
            continue
        tiles = rasterize_tiles(feats, origins, tile_h=tile_h, tile_w=tile_w,
                                impl=impl)
        ids = torch.clamp(ids.long(), max=n_tiles)   # sentinel -> spare row
        out = out.index_put((ids,), tiles)
    return out[:n_tiles]
