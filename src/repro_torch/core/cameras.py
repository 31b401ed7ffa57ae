"""Structured orbital camera rig (paper §II "Camera Setup").

Port of ``repro.core.cameras``.  The rig is generated on the host in float64
(numpy, identical to the reference) and cast to float32 tensors, so both
packages see bit-identical cameras.  A batched camera carries an explicit
leading view axis: ``view (V, 4, 4)``, ``fx (V,)``, ``fy (V,)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import check_device


class Camera(NamedTuple):
    """Pinhole camera. view: (4,4) or (V,4,4) world->camera; fx/fy in
    pixels, () or (V,)."""
    view: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    width: int
    height: int

    @property
    def cx(self):
        return self.width / 2.0

    @property
    def cy(self):
        return self.height / 2.0


def look_at(eye, center, up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    if np.linalg.norm(s) < 1e-8:           # looking along up: pick another up
        s = np.cross(f, np.array([1.0, 0.0, 0.0]))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, f   # camera looks down +z
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = -f @ eye
    return m


def orbital_rig(n_views: int, center, radius: float, *, width: int,
                height: int, fov_deg: float = 50.0,
                device="cuda") -> Camera:
    """Fibonacci-spiral orbit: identical on every node given identical args."""
    dev = check_device(device)
    center = np.asarray(center, np.float64)
    golden = (1 + 5**0.5) / 2
    views = []
    for i in range(n_views):
        # z in (-0.95, 0.95) avoids degenerate poles
        z = 0.95 * (2 * (i + 0.5) / n_views - 1)
        r = np.sqrt(max(1 - z * z, 1e-9))
        phi = 2 * np.pi * i / golden
        eye = center + radius * np.array([r * np.cos(phi), r * np.sin(phi), z])
        views.append(look_at(eye, center))
    view = torch.from_numpy(np.stack(views).astype(np.float32)).to(dev)
    focal = np.float32(0.5 * width / np.tan(np.radians(fov_deg) / 2))
    fx = torch.full((n_views,), float(focal), dtype=torch.float32, device=dev)
    return Camera(view=view, fx=fx, fy=fx.clone(), width=width, height=height)


def select(rig: Camera, idx) -> Camera:
    """Scalar idx -> one camera; index tensor/list -> a view-batched Camera."""
    return Camera(rig.view[idx], rig.fx[idx], rig.fy[idx], rig.width,
                  rig.height)


def stack(cams) -> Camera:
    """Single-view cameras (same image size) -> one view-batched Camera."""
    cams = list(cams)
    return Camera(view=torch.stack([c.view for c in cams]),
                  fx=torch.stack([c.fx for c in cams]),
                  fy=torch.stack([c.fy for c in cams]),
                  width=cams[0].width, height=cams[0].height)


def concat(rigs) -> Camera:
    """View-batched cameras (same image size) -> one rig, in order."""
    rigs = list(rigs)
    return Camera(view=torch.cat([r.view for r in rigs]),
                  fx=torch.cat([r.fx for r in rigs]),
                  fy=torch.cat([r.fy for r in rigs]),
                  width=rigs[0].width, height=rigs[0].height)
