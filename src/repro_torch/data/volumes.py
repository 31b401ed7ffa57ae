"""Analytic stand-ins for the paper's volume datasets (DESIGN.md §8).

A copy of ``repro.data.volumes`` (numpy only; the port imports nothing of
the JAX package, so it keeps its own copy).

Kingsnake / Rayleigh-Taylor / Richtmyer-Meshkov are not redistributable; we
generate analytic scalar fields with matched isosurface point-count tiers so
the *pipeline* (extraction -> partitioning -> ghosting -> training -> merge)
is exercised identically.  All fields are deterministic functions of (x,y,z)
on [0,1]^3 — no stored data, resolution-scalable to any point budget.

  kingsnake          gyroid lattice — intricate thin tubular structure, the
                     closest analytic analogue of a CT-scan isosurface
  rayleigh_taylor    perturbed mixing interface: z displaced by a sum of
                     sinusoidal modes + growing plume harmonics [7]
  richtmyer_meshkov  two-scale multimode interface (the RM setup of [8]):
                     long-wavelength modes + deterministic high-frequency
                     turbulent spectrum
  sphere_shell       trivial debug dataset
"""

from __future__ import annotations

import numpy as np


def _grid(res: int):
    ax = (np.arange(res, dtype=np.float32) + 0.5) / res
    return np.meshgrid(ax, ax, ax, indexing="ij")


def sphere_shell(res: int):
    x, y, z = _grid(res)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return r, 0.35


def kingsnake(res: int):
    """Gyroid: sin(kx)cos(ky) + sin(ky)cos(kz) + sin(kz)cos(kx) = iso."""
    x, y, z = _grid(res)
    k = 6 * np.pi
    f = (np.sin(k * x) * np.cos(k * y)
         + np.sin(k * y) * np.cos(k * z)
         + np.sin(k * z) * np.cos(k * x))
    return f, 0.0


def rayleigh_taylor(res: int):
    x, y, z = _grid(res)
    rng = np.random.default_rng(7)
    f = z - 0.5
    for kx, ky in [(2, 3), (3, 2), (5, 4), (4, 5)]:
        amp = 0.06 / max(kx, ky)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        f -= amp * np.sin(2 * np.pi * kx * x + ph1) * np.sin(2 * np.pi * ky * y + ph2)
    # plume harmonics: sharpen spikes/bubbles
    f -= 0.05 * np.sin(2 * np.pi * 2 * x) ** 3 * np.sin(2 * np.pi * 3 * y) ** 3
    return f, 0.0


def richtmyer_meshkov(res: int):
    """Two-scale initial perturbation (Cohen et al. [8]): one long mode +
    a band of short modes with deterministic pseudo-random phases."""
    x, y, z = _grid(res)
    rng = np.random.default_rng(42)
    f = z - 0.5
    f -= 0.08 * np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)  # long mode
    for _ in range(12):                                        # short band
        kx, ky = rng.integers(6, 14, 2)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        f -= (0.16 / (kx + ky)) * np.sin(2 * np.pi * kx * x + ph1) \
            * np.sin(2 * np.pi * ky * y + ph2)
    # roll-up wrinkles (post-shock turbulence proxy)
    f += 0.01 * np.sin(24 * np.pi * x) * np.sin(24 * np.pi * y) \
        * np.sin(12 * np.pi * z)
    return f, 0.0


VOLUMES = {
    "sphere_shell": sphere_shell,
    "kingsnake": kingsnake,
    "rayleigh_taylor": rayleigh_taylor,
    "richtmyer_meshkov": richtmyer_meshkov,
}


def make_volume(name: str, res: int, t: float = 0.0):
    """-> (field (res,res,res) float32 numpy, iso value).

    ``t`` evolves the field in time (the timeseries driver's analytic
    stand-in for a simulation dumping one snapshot per step): a bounded
    travelling multi-mode displacement advects the isosurface smoothly and
    deterministically, so successive timesteps share large-scale structure
    — exactly the regime warm-starting exploits — while every crossing
    moves.  ``t=0`` is bit-identical to the static field (the guard skips
    the perturbation entirely), so all pre-timeseries callers and caches
    are unaffected.
    """
    f, iso = VOLUMES[name](res)
    f = f.astype(np.float32)
    if t:
        tt = float(t)
        x, y, z = _grid(res)
        w = (np.sin(2 * np.pi * (2.0 * x + 0.61 * tt))
             * np.sin(2 * np.pi * (3.0 * y - 0.83 * tt))
             * np.cos(2 * np.pi * (1.0 * z + 0.47 * tt)))
        w += 0.5 * np.sin(2 * np.pi * (5.0 * x - 0.31 * tt)) \
            * np.sin(2 * np.pi * (4.0 * y + 0.53 * tt))
        # tanh bounds the amplitude so late timesteps deform, never destroy,
        # the surface (the field's own structure stays dominant)
        f = f + (0.06 * np.tanh(tt)) * w.astype(np.float32)
        f = f.astype(np.float32)
    return f, float(iso)


def height_colors(points: np.ndarray) -> np.ndarray:
    """Simple deterministic colormap: height + radial blend, in [0.05, 0.95]
    (kept off the sigmoid saturation ends so colors are trainable)."""
    z = points[:, 2]
    r = np.linalg.norm(points[:, :2] - 0.5, axis=1)
    c = np.stack([
        0.15 + 0.7 * z,
        0.2 + 0.6 * (1 - z) * (1 - np.clip(r * 1.4, 0, 1)),
        0.25 + 0.6 * np.clip(r * 1.4, 0, 1),
    ], axis=-1)
    return np.clip(c, 0.05, 0.95).astype(np.float32)
