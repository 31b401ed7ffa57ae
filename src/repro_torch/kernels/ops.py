"""Public entry points for the rasterizer (port of ``repro.kernels.ops``).

``rasterize_tiles(feats, origins, tile_h=, tile_w=, impl=)``:

  impl="cuda"   the hand-written CUDA kernel (kernels/rasterize.py); CUDA
                tensors only
  impl="ref"    the plain PyTorch version (kernels/ref.py); CPU tensors only
  impl="auto"   "cuda" for CUDA tensors, "ref" for CPU tensors

No path falls back from the kernel to the plain version: on a CUDA tensor
the kernel launches or the call raises.  On CUDA tensors the forward goes
through a ``torch.autograd.Function`` whose backward raises until the
backward kernel (``rasterize_bwd``) is ported with the training slice.

  rasterize_tiles          one (T,) launch at a single K
  rasterize_tiles_batched  view-batched: (V, T) flattened to one (V*T,)
                           launch
"""

from __future__ import annotations

import torch

from repro_torch.kernels import rasterize as rk
from repro_torch.kernels import ref as ref_impl

IMPLS = ("auto", "ref", "cuda")


class _RasterizeCUDA(torch.autograd.Function):
    """The CUDA forward; its backward kernel comes with training."""

    @staticmethod
    def forward(ctx, feats, origins, tile_h: int, tile_w: int):
        return rk.rasterize_fwd(feats, origins, tile_h=tile_h, tile_w=tile_w)

    @staticmethod
    def backward(ctx, gout):
        raise NotImplementedError(
            "the CUDA rasterizer has no backward yet: rasterize_bwd is "
            "ported with the training slice (autograd through the plain "
            "version is not used as a stand-in)")


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
