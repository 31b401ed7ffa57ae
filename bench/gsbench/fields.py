"""The benchmark's scalar fields: frozen torch copies of the analytic volumes
that stand in for the paper's data sets, made on the device.

In a deployment the field is the simulation's output, which is input data,
so the benchmark makes it itself (on the card, in a few large calls) and
hands it to the program's isosurface extraction.  The formulas are those of
the program's ``data/volumes.py`` at t = 0 (float32 throughout, cell-centred
grid on [0, 1]^3); a CPU test holds them against it.  Also here:
``height_colors``, the deterministic colour map the program's scenes use,
and the reference's own edge-crossing extraction, whole or slab by slab.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

#: Rayleigh-Taylor mixing layer: (kx, ky, phase x, phase y) of its four
#: modes, the fixed phases of the program's generator (seed 7), frozen
RT_MODES = (
    (2, 3, 3.927590651355011, 5.637360571650786),
    (3, 2, 4.873776931938056, 1.4150185072200883),
    (5, 4, 1.8860003910648933, 5.488698173149897),
    (4, 5, 0.033082884284244704, 5.159930332220927),
)


def _axis(res: int, device) -> torch.Tensor:
    return (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res


def gyroid(res: int, device, lo: int = 0, hi: int = None) -> torch.Tensor:
    """The kingsnake stand-in: sin(kx)cos(ky) + sin(ky)cos(kz) +
    sin(kz)cos(kx), k = 6 pi, iso 0 -> planes [lo, hi) of axis 0 of the
    (res, res, res) float32 field (all of it by default)."""
    a = _axis(res, device) * (6 * math.pi)
    s, c = torch.sin(a), torch.cos(a)
    # the axes are made whole and cut, so a slab holds the field's own bits
    sx, cx = s[lo:hi], c[lo:hi]
    f = sx[:, None, None] * c[None, :, None]
    f = f + s[None, :, None] * c[None, None, :]
    return f + s[None, None, :] * cx[:, None, None]


def rayleigh_taylor(res: int, device, lo: int = 0,
                    hi: int = None) -> torch.Tensor:
    """Cook et al.'s mixing interface: z - 0.5 less four sinusoidal modes
    and a plume harmonic, iso 0 -> planes [lo, hi) of axis 0 of the
    (res, res, res) float32 field (all of it by default)."""
    a = _axis(res, device)
    n = (res if hi is None else hi) - lo
    f = (a - 0.5)[None, None, :].expand(n, res, res).clone()
    for kx, ky, ph1, ph2 in RT_MODES:
        amp = 0.06 / max(kx, ky)
        sx = torch.sin(2 * math.pi * kx * a + ph1)[lo:hi]
        sy = torch.sin(2 * math.pi * ky * a + ph2)
        f -= (amp * sx)[:, None, None] * sy[None, :, None]
    px = (torch.sin(2 * math.pi * 2 * a) ** 3)[lo:hi]
    py = torch.sin(2 * math.pi * 3 * a) ** 3
    f -= (0.05 * px)[:, None, None] * py[None, :, None]
    return f


FIELDS = {"gyroid": gyroid, "rayleigh_taylor": rayleigh_taylor}


def make_field(name: str, res: int, device, lo: int = 0,
               hi: int = None) -> torch.Tensor:
    """The named field at resolution ``res`` on ``device``: planes [lo, hi)
    of axis 0, bit for bit those of the whole field (all by default)."""
    if name not in FIELDS:
        raise ValueError(f"unknown field {name!r}; expected one of "
                         f"{sorted(FIELDS)}")
    return FIELDS[name](res, device, lo, hi)


def height_colors(points: torch.Tensor) -> torch.Tensor:
    """Height + radial blend colour map, in [0.05, 0.95]: (n, 3) points ->
    (n, 3) float32 colours."""
    z = points[:, 2]
    r = torch.linalg.norm(points[:, :2] - 0.5, dim=1)
    rc = torch.clamp(r * 1.4, 0, 1)
    c = torch.stack([0.15 + 0.7 * z,
                     0.2 + 0.6 * (1 - z) * (1 - rc),
                     0.25 + 0.6 * rc], -1)
    return torch.clamp(c, 0.05, 0.95).to(torch.float32)


def _edge_points(a: torch.Tensor, b: torch.Tensor, ax: int, res: int,
                 lo: int = 0) -> torch.Tensor:
    """The crossings of the edges from ``a`` to ``b``, one step along
    ``ax``, in row-major order, their planes along axis 0 offset by ``lo``
    -> (n, 3) float32 ``(ijk + t e_ax + 0.5) / res``."""
    ijk = torch.nonzero((a * b) < 0)
    i, j, k = ijk.unbind(1)
    av, bv = a[i, j, k], b[i, j, k]
    t = av / (av - bv + 1e-30)
    if lo:
        ijk[:, 0] += lo
    step = torch.zeros(3, dtype=torch.float32, device=a.device)
    step[ax] = 1.0
    return (ijk.to(torch.float32) + t[:, None] * step + 0.5) / res


def crossings(field: torch.Tensor, iso: float = 0.0) -> torch.Tensor:
    """Every grid-edge crossing of ``field`` at ``iso``, the reference's own
    extraction: axis-major, row-major within an axis, each point
    ``(ijk + t e_ax + 0.5) / R`` with ``t = a / (a - b + 1e-30)`` ->
    (n, 3) float32 on the field's device."""
    R = field.shape[0]
    f = field - iso
    return torch.cat([_edge_points(f.narrow(ax, 0, R - 1),
                                   f.narrow(ax, 1, R - 1), ax, R)
                      for ax in range(3)])


def crossings_by_slab(make: Callable[[int, int], torch.Tensor], res: int,
                      iso: float = 0.0, planes: int = 64) -> torch.Tensor:
    """``crossings`` of a field made slab by slab, bit for bit and in its
    order: ``make(lo, hi)`` returns planes [lo, hi) of axis 0 of the
    (res, res, res) field.  One slab of ``planes`` planes and the next
    plane is made at a time, so only one slab's temporaries are held; an
    edge along axis 0 is counted by its lower plane, and each axis's
    points are joined after the last slab -> (n, 3) float32."""
    if planes < 1:
        raise ValueError(f"planes must be at least 1, not {planes}")
    per_axis = ([], [], [])
    for lo in range(0, res, planes):
        own = min(planes, res - lo)
        hi = min(lo + own + 1, res)
        f = make(lo, hi)
        if tuple(f.shape) != (hi - lo, res, res):
            raise ValueError(f"make({lo}, {hi}) gave {tuple(f.shape)}, not "
                             f"{(hi - lo, res, res)}")
        f = f - iso
        m = hi - lo
        per_axis[0].append(_edge_points(f.narrow(0, 0, m - 1),
                                        f.narrow(0, 1, m - 1), 0, res, lo))
        g = f.narrow(0, 0, own)
        for ax in (1, 2):
            per_axis[ax].append(_edge_points(g.narrow(ax, 0, res - 1),
                                             g.narrow(ax, 1, res - 1), ax,
                                             res, lo))
        del f, g
    return torch.cat([p for axis in per_axis for p in axis])
