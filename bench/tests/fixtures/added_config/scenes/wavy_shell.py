"""The point source of ``wavy_shell``, a configuration that brings its own
field: a sphere shell of radius 0.3 round the box's centre, rippled by
a product of two sine waves, made slab by slab.

The program's side stacks the slabs and hands the field to the program's
extraction; the reference's side extracts each slab as it is made
(``fields.crossings_by_slab``), so it never holds the whole field.
``SHIFT`` moves the program's points by that many rows against the rows
it reports (0: none).
"""

import math

import torch

from gsbench import fields, scene

SHIFT = 0


def field_slab(res: int, lo: int, hi: int, device) -> torch.Tensor:
    """Planes [lo, hi) of axis 0 of the (res, res, res) float32 field."""
    a = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    c = a - 0.5
    wave = 0.03 * torch.sin(8 * math.pi * a)
    r = torch.sqrt(c[lo:hi, None, None] ** 2 + c[None, :, None] ** 2
                   + c[None, None, :] ** 2)
    return r - 0.3 - wave[lo:hi, None, None] * wave[None, :, None]


def points(cfg: dict, seed: int, device):
    from repro_torch.data.isosurface import extract_isosurface
    res, planes = int(cfg["resolution"]), int(cfg["planes"])
    field = torch.cat([field_slab(res, lo, min(lo + planes, res), device)
                       for lo in range(0, res, planes)])
    pts, count = extract_isosurface(field, float(cfg["iso"]),
                                    max_points=int(cfg["max_crossings"]))
    del field
    count = int(count)
    rows = scene.select_rows(count, int(cfg["points"]), seed)
    pts = pts[torch.from_numpy((rows + SHIFT) % count).to(pts.device)]
    return pts, fields.height_colors(pts), rows, count


def reference_points(cfg: dict, device) -> torch.Tensor:
    res = int(cfg["resolution"])
    return fields.crossings_by_slab(
        lambda lo, hi: field_slab(res, lo, hi, device), res,
        float(cfg["iso"]), int(cfg["planes"]))
