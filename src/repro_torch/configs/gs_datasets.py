"""GS dataset configs — the paper's three benchmarks + a debug set.

A copy of ``repro.configs.gs_datasets`` (the port imports nothing of the
JAX package).

``full`` tiers match the paper's point counts (dry-run / production only);
``cpu`` tiers are CPU-tractable reductions used by tests, examples and the
quality benchmarks (same pipeline, smaller N / images / views).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GSDataset:
    name: str
    volume: str                  # key into repro_torch.data.volumes.VOLUMES
    n_points: int                # isosurface point budget (== #initial splats)
    n_views: int = 448           # paper: 448 training images per dataset
    resolutions: Tuple[int, ...] = (512, 1024, 2048)
    # training defaults
    capacity_factor: float = 1.3  # gaussian buffer headroom for densification
    ghost_frac: float = 0.03      # ghost halo width as fraction of extent
    source: str = ""


FULL = {
    "kingsnake": GSDataset(
        "kingsnake", "kingsnake", n_points=4_000_000,
        source="digimorph kingsnake scan, ~4M points (paper §III)"),
    "rayleigh_taylor": GSDataset(
        "rayleigh_taylor", "rayleigh_taylor", n_points=18_200_000,
        source="Cook et al. [7], ~18.2M points"),
    "richtmyer_meshkov": GSDataset(
        "richtmyer_meshkov", "richtmyer_meshkov", n_points=106_700_000,
        source="Cohen et al. [8], ~106.7M points"),
}

CPU = {
    "kingsnake": GSDataset(
        "kingsnake", "kingsnake", n_points=6_000, n_views=24,
        resolutions=(64, 128)),
    "rayleigh_taylor": GSDataset(
        "rayleigh_taylor", "rayleigh_taylor", n_points=12_000, n_views=24,
        resolutions=(64, 128)),
    "richtmyer_meshkov": GSDataset(
        "richtmyer_meshkov", "richtmyer_meshkov", n_points=24_000, n_views=24,
        resolutions=(64, 128)),
    "sphere_shell": GSDataset(
        "sphere_shell", "sphere_shell", n_points=2_000, n_views=12,
        resolutions=(64,)),
}

# scaling-benchmark tier: large enough that per-step cost is dominated by the
# gaussian count (the paper's speedup mechanism), still CPU-tractable.  Keeps
# the paper's ~1 : 4.5 : 26 size ratios.
SCALE = {
    "kingsnake": GSDataset(
        "kingsnake", "kingsnake", n_points=60_000, n_views=8,
        resolutions=(48, 64)),
    "rayleigh_taylor": GSDataset(
        "rayleigh_taylor", "rayleigh_taylor", n_points=270_000, n_views=8,
        resolutions=(48, 64)),
    "richtmyer_meshkov": GSDataset(
        "richtmyer_meshkov", "richtmyer_meshkov", n_points=540_000, n_views=8,
        resolutions=(48, 64)),
}


def get_gs_dataset(name: str, tier: str = "cpu") -> GSDataset:
    return {"full": FULL, "cpu": CPU, "scale": SCALE}[tier][name]
