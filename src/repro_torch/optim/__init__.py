"""Optimizer side of both trainers (port of ``repro.optim``): AdamW, the LR
schedules and gradient wire compression."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedules import make_schedule
from repro_torch.optim.compress import compress_grads
