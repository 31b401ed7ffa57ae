"""Image quality metrics: PSNR, SSIM (+ masked variants), D-SSIM loss term.

Port of ``repro.core.metrics``.  Images are (..., H, W, C) in [0, 1], the
reference's layout; SSIM's window is a SAME-padded ``conv2d``.  LPIPS needs
a pretrained network, so ``grad_sim`` (a gradient-similarity proxy) stands
where the paper reports it, as in the reference.

On a CUDA tensor the convolution goes through cuDNN, which runs float32 in
TF32 unless ``torch.backends.cudnn.allow_tf32`` is False; a caller that
compares against the reference sets it (``chip_smoke.py`` does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a, b, mask=None):
    """a, b: (..., H, W, C) in [0, 1]."""
    se = (a.to(torch.float32) - b.to(torch.float32)) ** 2
    if mask is None:
        mse = se.mean()
    else:
        m = mask.to(torch.float32)[..., None]
        mse = (se * m).sum() / torch.clamp(m.sum() * se.shape[-1], min=1.0)
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(img, win):
    """img: (H, W, C); win: (k, k) -> the same-size (SAME-padded) filter."""
    k = win.shape[0]
    x = img.permute(2, 0, 1)[:, None]                       # (C, 1, H, W)
    y = F.conv2d(x, win[None, None], padding=k // 2)
    return y[:, 0].permute(1, 2, 0)


def ssim_map(a, b, *, win_size: int = 11, sigma: float = 1.5):
    """Per-pixel SSIM map, (H, W, C) inputs in [0, 1] -> (H, W, C)."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    win = _gaussian_window(win_size, sigma, device=a.device)
    mu_a = _filter2d(a, win)
    mu_b = _filter2d(b, win)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2d(a * a, win) - mu_aa
    s_bb = _filter2d(b * b, win) - mu_bb
    s_ab = _filter2d(a * b, win) - mu_ab
    return ((2 * mu_ab + c1) * (2 * s_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2))


def ssim(a, b, mask=None, **kw):
    m = ssim_map(a, b, **kw)
    if mask is None:
        return m.mean()
    w = mask.to(torch.float32)[..., None]
    return (m * w).sum() / torch.clamp(w.sum() * m.shape[-1], min=1.0)


def d_ssim(a, b, mask=None, **kw):
    """3D-GS loss term: (1 - SSIM) / 2."""
    return (1.0 - ssim(a, b, mask=mask, **kw)) / 2.0


def grad_sim(a, b, mask=None):
    """LPIPS stand-in (documented proxy): 1 - cosine similarity of image
    gradients, lower is better, in [0, 2]."""
    def grads(x):
        x = x.to(torch.float32).mean(-1)
        gx = x[:, 1:] - x[:, :-1]
        gy = x[1:, :] - x[:-1, :]
        return gx[:-1], gy[:, :-1]

    ax, ay = grads(a)
    bx, by = grads(b)
    if mask is not None:
        m = mask.to(torch.float32)[:-1, :-1]
        ax, ay, bx, by = ax * m, ay * m, bx * m, by * m
    num = (ax * bx + ay * by).sum()
    den = torch.sqrt((ax ** 2 + ay ** 2).sum() * (bx ** 2 + by ** 2).sum())
    return 1.0 - num / torch.clamp(den, min=1e-12)
