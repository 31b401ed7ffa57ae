"""Plain PyTorch versions of the tile rasterizer (port of
``repro.kernels.ref``).

Front-to-back alpha compositing of the per-tile top-K splat lists, with the
3D-GS clamps (alpha <= 0.99, alpha < 1/255 skipped, sigma >= 0) and no
early termination — the same math as the CUDA kernels
(``kernels/csrc/rasterize_{fwd,bwd}.cu``), which are held against these.

  * ``rasterize_tiles_ref``      — a Python loop over K (O(pixels) live
                                   memory); the CPU path, differentiable
                                   by autograd.
  * ``rasterize_tiles_unrolled`` — vectorised over K with an exclusive
                                   cumprod (an independent second oracle).
  * ``rasterize_bwd_ref``        — the backward: the VJP of
                                   ``rasterize_tiles_ref`` by autograd,
                                   padding columns 0 (the CUDA
                                   ``rasterize_bwd`` is held against it).
  * ``rasterize_bwd_emulate``    — the backward kernel's own single-sweep
                                   algorithm (suffix = C - prefix), written
                                   in PyTorch: a second oracle that shares
                                   the kernel's cancellation, not autograd's.

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


def _alpha_terms(f, px, py):
    """f: (..., F) feature rows broadcast against pixel grids px/py ->
    (dx, dy, sigma, g, a_g, alpha, live), as the kernels' alpha_terms.cuh
    computes them."""
    dx = px - f[..., 0]
    dy = py - f[..., 1]
    sigma = 0.5 * (f[..., 2] * dx * dx + f[..., 4] * dy * dy) \
        + f[..., 3] * dx * dy
    g = torch.exp(-torch.clamp(sigma, min=0.0))
    a_g = f[..., 8] * g
    alpha = torch.clamp(a_g, max=ALPHA_MAX)
    live = alpha >= ALPHA_MIN
    return dx, dy, sigma, g, a_g, torch.where(live, alpha, 0.0), live


def _splat_alpha(f, px, py):
    """f: (..., F) feature rows broadcast against pixel grids px/py."""
    return _alpha_terms(f, px, py)[5]


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


def rasterize_bwd_ref(feats, origins, out, gout, *, tile_h: int,
                      tile_w: int):
    """Plain backward: feats (T, K, F), origins (T, 2), the forward output
    ``out`` and its cotangent ``gout`` (T, 4, th, tw) -> gfeats (T, K, F)
    float32, the VJP of ``rasterize_tiles_ref`` taken with
    ``torch.autograd.grad``; columns 9.. are 0.  ``out`` is not read (the
    VJP recomputes the forward); it is in the signature so the plain
    version and the kernel take the same arguments."""
    del out
    with torch.enable_grad():
        f = feats.detach().to(torch.float32).requires_grad_(True)
        img = rasterize_tiles_ref(f, origins.to(torch.float32),
                                  tile_h=tile_h, tile_w=tile_w)
        (gf,) = torch.autograd.grad(img, f, gout.to(torch.float32))
    gf = gf.clone()
    gf[..., 9:] = 0.0
    return gf


def rasterize_bwd_emulate(feats, origins, out, gout, *, tile_h: int,
                          tile_w: int):
    """The backward kernel's algorithm in PyTorch: one front-to-back sweep
    per pixel, each suffix sum recovered as C - prefix_k, the 9 terms
    summed over the tile's pixels (``_bwd_kernel`` of the reference, and
    ``csrc/rasterize_bwd.cu``).  Same signature and output as
    ``rasterize_bwd_ref``."""
    feats = feats.to(torch.float32)
    out = out.to(torch.float32)
    gout = gout.to(torch.float32)
    T, K, F = feats.shape
    px, py = _pixel_centers(origins.to(torch.float32), tile_h, tile_w)
    c_r, c_g, c_b = out[:, 0], out[:, 1], out[:, 2]
    t_final = 1.0 - out[:, 3]
    g_r, g_g, g_b, g_cov = gout[:, 0], gout[:, 1], gout[:, 2], gout[:, 3]
    trans = torch.ones_like(px)
    pr = torch.zeros_like(px)
    pg = torch.zeros_like(px)
    pb = torch.zeros_like(px)
    gfeats = torch.zeros((T, K, F), dtype=torch.float32, device=feats.device)
    for k in range(K):
        f = feats[:, k, None, None, :]                  # (T, 1, 1, F)
        dx, dy, sigma, g, a_g, alpha, live = _alpha_terms(f, px, py)
        w = trans * alpha
        pr = pr + w * f[..., 5]
        pg = pg + w * f[..., 6]
        pb = pb + w * f[..., 7]
        denom = 1.0 - alpha
        g_alpha = (g_r * (trans * f[..., 5] - (c_r - pr) / denom)
                   + g_g * (trans * f[..., 6] - (c_g - pg) / denom)
                   + g_b * (trans * f[..., 7] - (c_b - pb) / denom)
                   + g_cov * (t_final / denom))
        g_ag = torch.where(live & (a_g < ALPHA_MAX), g_alpha, 0.0)
        g_sigma = torch.where(sigma > 0.0, -a_g * g_ag, 0.0)
        terms = torch.stack([
            -(f[..., 2] * dx + f[..., 3] * dy) * g_sigma,
            -(f[..., 4] * dy + f[..., 3] * dx) * g_sigma,
            0.5 * dx * dx * g_sigma,
            dx * dy * g_sigma,
            0.5 * dy * dy * g_sigma,
            g_r * w,
            g_g * w,
            g_b * w,
            g_ag * g,
        ], dim=1)                                       # (T, 9, th, tw)
        gfeats[:, k, :9] = terms.sum(dim=(2, 3))
        trans = trans * denom
    return gfeats
