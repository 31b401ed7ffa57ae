"""EWA projection of 3D Gaussians to screen space + frustum culling.

Port of ``repro.core.projection``.  Output per gaussian: 2D mean (pixels),
2D covariance ([a, b, c] packed), depth, rgb, alpha, valid flag.

The view axis is explicit: a single camera (view (4, 4)) gives (N, ...)
splats, a batched camera (view (V, 4, 4)) gives (V, N, ...) splats — the
counterpart of the reference's ``jax.vmap`` over cameras.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cameras import Camera
from repro_torch.core.gaussians import Gaussians, covariance3d

# anti-aliasing dilation as in 3D-GS reference (0.3 px)
COV2D_DILATE = 0.3


class Splats2D(NamedTuple):
    mean2d: torch.Tensor     # (..., 2) pixel coords
    cov2d: torch.Tensor      # (..., 3) packed [a, b, c] of [[a, b], [b, c]]
    depth: torch.Tensor      # (...,)
    rgb: torch.Tensor        # (..., 3) in [0,1]
    alpha: torch.Tensor      # (...,)
    radius: torch.Tensor     # (...,) conservative pixel radius
    valid: torch.Tensor      # (...,) bool


def project(g: Gaussians, cam: Camera, *, near: float = 0.05,
            alpha_min: float = 1.0 / 255.0) -> Splats2D:
    """Project all gaussians for one camera, or for each view of a batched
    camera (leading V axis on every output field)."""
    batched = cam.view.dim() == 3
    view = cam.view if batched else cam.view[None]          # (V, 4, 4)
    fx = cam.fx.reshape(-1, 1)                               # (V, 1)
    fy = cam.fy.reshape(-1, 1)
    R = view[:, :3, :3]
    t = view[:, :3, 3]
    p_cam = torch.matmul(g.means, R.transpose(1, 2)) + t[:, None, :]
    x = p_cam[..., 0]                                        # (V, N)
    y = p_cam[..., 1]
    z = p_cam[..., 2]
    zc = torch.clamp(z, min=near)
    u = fx * x / zc + cam.cx
    v = fy * y / zc + cam.cy

    # Jacobian of perspective projection (EWA affine approximation)
    zero = torch.zeros_like(zc)
    J = torch.stack(
        [
            torch.stack([fx / zc, zero, -fx * x / (zc * zc)], -1),
            torch.stack([zero, fy / zc, -fy * y / (zc * zc)], -1),
        ],
        dim=-2,
    )                                                        # (V, N, 2, 3)
    cov3 = covariance3d(g.log_scales, g.quats)               # (N, 3, 3)
    T = torch.einsum("vnij,vjk->vnik", J, R)                 # (V, N, 2, 3)
    cov2 = torch.matmul(torch.matmul(T, cov3), T.transpose(-1, -2))
    a = cov2[..., 0, 0] + COV2D_DILATE
    b = cov2[..., 0, 1]
    c = cov2[..., 1, 1] + COV2D_DILATE

    det = a * c - b * b
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=1e-9))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=1e-9)))

    alpha = torch.sigmoid(g.opacity_logit).expand_as(z)
    rgb = torch.sigmoid(g.colors).expand(z.shape + (3,))

    inside = (
        (z > near)
        & (u + radius > 0) & (u - radius < cam.width)
        & (v + radius > 0) & (v - radius < cam.height)
    )
    valid = inside & g.active & (alpha > alpha_min) & (det > 1e-12)
    out = Splats2D(
        mean2d=torch.stack([u, v], -1),
        cov2d=torch.stack([a, b, c], -1),
        depth=z,
        rgb=rgb,
        alpha=alpha,
        radius=radius,
        valid=valid,
    )
    return out if batched else Splats2D(*(f[0] for f in out))
