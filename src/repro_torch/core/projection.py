"""EWA projection of 3D Gaussians to screen space + frustum culling.

Port of ``repro.core.projection``.  Output per gaussian: 2D mean (pixels),
2D covariance ([a, b, c] packed), depth, rgb, alpha, valid flag.

The view axis is explicit: a single camera (view (4, 4)) gives (N, ...)
splats, a batched camera (view (V, 4, 4)) gives (V, N, ...) splats — the
counterpart of the reference's ``jax.vmap`` over cameras.

``project(g, cam)`` follows the tensors' device: on CUDA tensors it runs
the hand-written CUDA kernel pair (kernels/project.py), ``project_fwd``
forward and ``project_bwd`` backward, through a ``torch.autograd.Function``;
on CPU tensors the plain PyTorch version, ``project_ref``.  No path falls
back from the kernel to the plain version: on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cameras import Camera
from repro_torch.core.gaussians import Gaussians, covariance3d
from repro_torch.kernels import project as pk
from repro_torch.runtime import spans

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


class _ProjectCUDA(torch.autograd.Function):
    """The CUDA kernel pair: ``project_fwd`` forward, ``project_bwd``
    backward, which recomputes the forward from the saved inputs.  radius
    and valid carry no gradient; neither do alpha, active or the camera."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, alpha, active, view, fx, fy,
                width: int, height: int, near: float, alpha_min: float):
        out = pk.project_fwd(means, log_scales, quats, alpha, active, view,
                             fx, fy, width=width, height=height, near=near,
                             alpha_min=alpha_min)
        ctx.save_for_backward(means, log_scales, quats, view, fx, fy)
        ctx.near = near
        ctx.mark_non_differentiable(out[3], out[4])
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_cov2d, g_depth, _g_radius, _g_valid):
        grads = pk.project_bwd(*ctx.saved_tensors, g_mean2d.contiguous(),
                               g_cov2d.contiguous(), g_depth.contiguous(),
                               near=ctx.near)
        return grads + (None,) * 9


def project(g: Gaussians, cam: Camera, *, near: float = 0.05,
            alpha_min: float = 1.0 / 255.0) -> Splats2D:
    """Project all gaussians for one camera, or for each view of a batched
    camera (leading V axis on every output field): the CUDA kernel pair on
    CUDA tensors, ``project_ref`` on CPU tensors.  Span ``project``."""
    with spans.span("project"):
        if g.means.is_cuda:
            return _project_cuda(g, cam, near, alpha_min)
        return project_ref(g, cam, near=near, alpha_min=alpha_min)


def _project_cuda(g: Gaussians, cam: Camera, near: float,
                  alpha_min: float) -> Splats2D:
    batched = cam.view.dim() == 3
    view = cam.view if batched else cam.view[None]               # (V, 4, 4)
    if view.requires_grad or cam.fx.requires_grad or cam.fy.requires_grad:
        raise ValueError("the CUDA projection gives the camera no gradient")
    alpha_n = torch.sigmoid(g.opacity_logit)
    mean2d, cov2d, depth, radius, valid = _ProjectCUDA.apply(
        g.means.contiguous(), g.log_scales.contiguous(),
        g.quats.contiguous(), alpha_n.detach().contiguous(),
        g.active.contiguous(), view.contiguous(),
        cam.fx.reshape(-1).contiguous(), cam.fy.reshape(-1).contiguous(),
        cam.width, cam.height, near, alpha_min)
    out = Splats2D(
        mean2d=mean2d,
        cov2d=cov2d,
        depth=depth,
        rgb=torch.sigmoid(g.colors).expand(depth.shape + (3,)),
        alpha=alpha_n.expand_as(depth),
        radius=radius,
        valid=valid,
    )
    return out if batched else Splats2D(*(f[0] for f in out))


def project_ref(g: Gaussians, cam: Camera, *, near: float = 0.05,
                alpha_min: float = 1.0 / 255.0) -> Splats2D:
    """The plain PyTorch version of ``project`` (CPU tensors in the port;
    the CUDA kernels are held against it)."""
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
