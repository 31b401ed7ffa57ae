"""Runtime: checkpoint/restart and fault tolerance (port of
``repro.runtime``)."""

from repro_torch.runtime.checkpoint import (CheckpointManager, UNSHAPED,
                                            unshaped_like)
from repro_torch.runtime.ft import (Heartbeat, bounded_staleness_merge,
                                    retry_step)
