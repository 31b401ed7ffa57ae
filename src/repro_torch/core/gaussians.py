"""Gaussian primitive parameterisation (3D-GS, Kerbl et al. 2023).

Port of ``repro.core.gaussians``.  A scene is a fixed-capacity buffer of
Gaussians with an ``active`` mask.

Parameterisation (trainable, unconstrained):
  means    (N, 3)      world-space centers
  log_scales (N, 3)    exp() -> per-axis std dev
  quats    (N, 4)      normalised on use -> rotation
  opacity_logit (N,)   sigmoid() -> alpha in (0,1)
  colors   (N, 3)      SH degree-0; sigmoid() -> rgb
plus non-trainable:
  active   (N,) bool
  owner    (N,) int32  spatial partition that owns this gaussian

``gaussians_from_numpy`` / ``gaussians_to_numpy`` carry a model across from
(and back to) the reference: the same field names, as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch import check_device


class Gaussians(NamedTuple):
    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logit: torch.Tensor
    colors: torch.Tensor
    active: torch.Tensor
    owner: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def trainable(self):
        """The five trained fields, by name (the reference's layout of the
        parameter and optimizer-moment trees)."""
        return {
            "means": self.means,
            "log_scales": self.log_scales,
            "quats": self.quats,
            "opacity_logit": self.opacity_logit,
            "colors": self.colors,
        }

    def with_trainable(self, t):
        """A copy with the trained fields replaced from the dict ``t``."""
        return self._replace(
            means=t["means"],
            log_scales=t["log_scales"],
            quats=t["quats"],
            opacity_logit=t["opacity_logit"],
            colors=t["colors"],
        )


#: numpy dtype of each field, as the reference stores it
_FIELD_DTYPES = {
    "means": np.float32, "log_scales": np.float32, "quats": np.float32,
    "opacity_logit": np.float32, "colors": np.float32, "active": np.bool_,
    "owner": np.int32,
}


def gaussians_from_numpy(d: Dict[str, np.ndarray],
                         device="cuda") -> Gaussians:
    """Reference ``Gaussians`` fields as numpy arrays (``np.asarray`` of
    each) -> a port ``Gaussians`` on ``device``."""
    dev = check_device(device)
    return Gaussians(**{
        name: torch.from_numpy(
            np.array(d[name], dtype=_FIELD_DTYPES[name], copy=True)).to(dev)
        for name in Gaussians._fields})


def gaussians_to_numpy(g: Gaussians) -> Dict[str, np.ndarray]:
    """-> {field: numpy array}, the inverse of ``gaussians_from_numpy``."""
    return {name: getattr(g, name).detach().cpu().numpy()
            for name in Gaussians._fields}


def from_points(points, colors=None, *, capacity=None, init_scale=None,
                owner_id=0, opacity=0.6, device="cuda") -> Gaussians:
    """Initialise one Gaussian per point (isosurface point cloud -> initial
    primitives).  ``points`` / ``colors`` are (n, 3) arrays or tensors.
    init_scale defaults to mean nearest-neighbour-ish spacing estimated from
    the bounding box and point count (computed in float32, as the reference
    does)."""
    dev = check_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    if init_scale is None:
        bbox = points.max(0).values - points.min(0).values
        vol = torch.clamp(torch.prod(bbox), min=1e-12)
        init_scale = (vol / max(n, 1)) ** (1.0 / 3.0)
    init_scale = torch.as_tensor(init_scale, dtype=torch.float32, device=dev)
    pad = capacity - n

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x

    f32 = dict(dtype=torch.float32, device=dev)
    means = padded(points)
    log_scales = torch.log(init_scale).expand(capacity, 3).clone()
    quats = torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(capacity, 1)
    logit = torch.log(torch.tensor(opacity / (1 - opacity), **f32))
    op = logit.expand(capacity).clone()
    if colors is None:
        colors = torch.zeros((n, 3), **f32)    # sigmoid(0)=0.5 grey
    else:
        c = torch.clamp(torch.as_tensor(colors, **f32), 1e-4, 1 - 1e-4)
        colors = torch.log(c / (1 - c))
    colors = padded(colors)
    active = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                        torch.zeros(pad, dtype=torch.bool, device=dev)])
    owner = torch.full((capacity,), owner_id, dtype=torch.int32, device=dev)
    return Gaussians(means, log_scales, quats, op, colors, active, owner)


def quat_to_rotmat(q):
    """(..., 4) normalised-on-use quaternion -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def covariance3d(log_scales, quats):
    """Sigma = R S S^T R^T, (..., 3, 3)."""
    R = quat_to_rotmat(quats)
    S = torch.exp(log_scales)
    RS = R * S[..., None, :]
    return RS @ RS.transpose(-1, -2)
