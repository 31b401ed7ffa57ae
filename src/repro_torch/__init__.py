"""PyTorch / CUDA port of the distributed 3D-GS isosurface system.

Mirrors the module paths and public names of the JAX package ``repro`` (the
reference): ``repro_torch/core/render.py`` is the counterpart of
``repro/core/render.py``, and so on.  Entry points that create tensors take
an explicit ``device=`` that defaults to ``"cuda"``; they raise when no card
is present, and run on the CPU only when the caller asks for it.
"""

from __future__ import annotations

import numpy as np
import torch


def as_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like -> a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card (the
    port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev
