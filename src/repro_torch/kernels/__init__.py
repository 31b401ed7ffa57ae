"""Hand-written CUDA kernels (+ plain PyTorch versions) for the GS render."""

from repro_torch.kernels.ops import rasterize_tiles, resolve_impl
