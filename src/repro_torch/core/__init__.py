"""Core of the port: primitives, projection, tiling, render and serving."""

from repro_torch.core.cameras import Camera, orbital_rig, select
from repro_torch.core.gaussians import Gaussians, from_points
from repro_torch.core.render import render
from repro_torch.core.serving import GSRenderServer, ServeCfg
from repro_torch.core.tiling import TileGrid
