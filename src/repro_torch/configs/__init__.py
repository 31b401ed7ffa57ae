"""Dataset configurations of the port (GS datasets only)."""

from repro_torch.configs.gs_datasets import get_gs_dataset
