"""Background masks + masked training loss (paper §II steps 4-5).

Port of ``repro.core.masking`` (``dilate_mask``, ``background_mask``,
``gs_loss``, ``tile_l1_dssim_loss``).  Each partition renders its own
data's coverage per camera; the training loss is evaluated only on covered
pixels (plus a small dilation so silhouette gradients survive).  The
distributed path evaluates it per tile.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import metrics
from repro_torch.core.cameras import Camera
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.render import render
from repro_torch.core.tiling import TileGrid


def dilate_mask(mask, it: int = 2):
    """Binary dilation of an (H, W) mask with a 3x3 structuring element,
    ``it`` iterations."""
    m = mask.to(torch.float32)[None, None]           # (1, 1, H, W)
    k = torch.ones((1, 1, 3, 3), dtype=torch.float32, device=m.device)
    for _ in range(it):
        m = torch.clamp(F.conv2d(m, k, padding=1), max=1.0)
    return m[0, 0] > 0.5


def background_mask(g: Gaussians, cam: Camera, grid: TileGrid, *,
                    K: int = 64, impl: str = "auto",
                    threshold: float = 1.0 / 255.0, dilation: int = 2):
    """Coverage mask of this partition's own data (ghosts included)."""
    out = render(g, cam, grid, K=K, impl=impl, bg=0.0)
    return dilate_mask(out.coverage > threshold, dilation)


def gs_loss(pred_rgb, gt_rgb, mask=None, *, lambda_dssim: float = 0.2):
    """3D-GS loss: (1-l)*L1 + l*D-SSIM, both restricted to masked pixels.
    mask=None is the unmasked baseline."""
    a = pred_rgb.to(torch.float32)
    b = gt_rgb.to(torch.float32)
    if mask is None:
        l1 = (a - b).abs().mean()
    else:
        m = mask.to(torch.float32)[..., None]
        l1 = ((a - b).abs() * m).sum() / torch.clamp(m.sum() * 3.0, min=1.0)
    dss = metrics.d_ssim(a, b, mask=mask)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * dss


def tile_l1_dssim_loss(pred_tiles, gt_tiles, mask_tiles=None, *,
                       lambda_dssim: float = 0.2, win_size: int = 7):
    """Per-tile loss of the distributed path: SSIM windows stay inside each
    tile (win 7 on 8-row tiles).  pred/gt (T, C, th, tw); mask (T, th, tw)
    or None."""
    a = pred_tiles.to(torch.float32)
    b = gt_tiles.to(torch.float32)
    if mask_tiles is None:
        m = torch.ones(a.shape[:1] + a.shape[2:], dtype=torch.float32,
                       device=a.device)
    else:
        m = mask_tiles.to(torch.float32)
    mc = m[:, None]
    l1 = ((a - b).abs() * mc).sum() / torch.clamp(mc.sum() * a.shape[1],
                                                  min=1.0)
    sm = metrics.tile_ssim_map(a, b, win_size=win_size)    # (T, th, tw, C)
    ww = m[..., None]
    ss = (sm * ww).sum() / torch.clamp(ww.sum() * sm.shape[-1], min=1.0)
    dss = (1.0 - ss) / 2.0
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * dss
