"""Data substrate: analytic volumes and isosurface point clouds."""

from repro_torch.data.volumes import VOLUMES, make_volume
from repro_torch.data.isosurface import point_cloud_for
