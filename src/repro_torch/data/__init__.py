"""Data substrate: analytic volumes, isosurface point clouds and synthetic
token streams."""

from repro_torch.data.volumes import VOLUMES, make_volume
from repro_torch.data.isosurface import point_cloud_for
from repro_torch.data.tokens import SyntheticTokens
