"""Plain PyTorch versions of the tile rasterizer (port of
``repro.kernels.ref``).

Front-to-back alpha compositing of the per-tile top-K splat lists, with the
3D-GS clamps (alpha <= 0.99, alpha < 1/255 skipped, sigma >= 0) and no
early termination — the same math as the CUDA kernel
(``kernels/csrc/rasterize_fwd.cu``), which is held against these.

  * ``rasterize_tiles_ref``      — a Python loop over K (O(pixels) live
                                   memory); the CPU path, differentiable
                                   by autograd.
  * ``rasterize_tiles_unrolled`` — vectorised over K with an exclusive
                                   cumprod (an independent second oracle).

Output per tile: (T, 4, th, tw) float32 = [r, g, b, coverage], coverage =
1 - prod(1 - alpha).
"""

from __future__ import annotations

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0


def _pixel_centers(origins, tile_h: int, tile_w: int):
    """origins: (T, 2) (x, y) -> px, py: (T, th, tw) pixel-center coords."""
    f32 = dict(dtype=torch.float32, device=origins.device)
    jx = torch.arange(tile_w, **f32) + 0.5
    iy = torch.arange(tile_h, **f32) + 0.5
    T = origins.shape[0]
    px = (origins[:, 0, None, None] + jx[None, None, :]).expand(
        T, tile_h, tile_w)
    py = (origins[:, 1, None, None] + iy[None, :, None]).expand(
        T, tile_h, tile_w)
    return px, py


def _splat_alpha(f, px, py):
    """f: (..., F) feature rows broadcast against pixel grids px/py."""
    dx = px - f[..., 0]
    dy = py - f[..., 1]
    sigma = 0.5 * (f[..., 2] * dx * dx + f[..., 4] * dy * dy) \
        + f[..., 3] * dx * dy
    g = torch.exp(-torch.clamp(sigma, min=0.0))
    alpha = torch.clamp(f[..., 8] * g, max=ALPHA_MAX)
    return torch.where(alpha < ALPHA_MIN, 0.0, alpha)


def rasterize_tiles_ref(feats, origins, *, tile_h: int, tile_w: int):
    """feats: (T, K, F) float32; origins: (T, 2) -> (T, 4, th, tw)."""
    T, K, _ = feats.shape
    px, py = _pixel_centers(origins, tile_h, tile_w)   # (T, th, tw)
    trans = torch.ones((T, tile_h, tile_w), dtype=torch.float32,
                       device=feats.device)
    r = torch.zeros_like(trans)
    g = torch.zeros_like(trans)
    b = torch.zeros_like(trans)
    for k in range(K):
        fk = feats[:, k, None, None, :]                 # (T, 1, 1, F)
        alpha = _splat_alpha(fk, px, py)
        w = trans * alpha
        trans = trans * (1.0 - alpha)
        r = r + w * fk[..., 5]
        g = g + w * fk[..., 6]
        b = b + w * fk[..., 7]
    return torch.stack([r, g, b, 1.0 - trans], dim=1)


def rasterize_tiles_unrolled(feats, origins, *, tile_h: int, tile_w: int):
    """Independent second oracle: vectorised over K with an exclusive
    cumprod."""
    T, K, _ = feats.shape
    px, py = _pixel_centers(origins, tile_h, tile_w)
    alpha = _splat_alpha(feats[:, :, None, None, :], px[:, None],
                         py[:, None])                   # (T, K, th, tw)
    keep = 1.0 - alpha
    # exclusive cumulative product along K: T_k = prod_{j<k} (1 - alpha_j)
    trans = torch.cat([torch.ones_like(keep[:, :1]),
                       torch.cumprod(keep, dim=1)[:, :-1]], dim=1)
    w = trans * alpha                                   # (T, K, th, tw)
    rgb = torch.einsum("tkhw,tkc->tchw", w, feats[:, :, 5:8])
    cov = 1.0 - torch.prod(keep, dim=1)
    return torch.cat([rgb, cov[:, None]], dim=1)
