"""Global reconstruction: merge per-partition splats (paper §II step 6).

Port of ``repro.core.merge`` (``dedupe_mask``, ``merge_partitions``).  A
partition contributes only the gaussians it owns (``owner == part_id``):
ghosts are the neighbour's responsibility, so every source gaussian appears
exactly once in the merged scene; densified children inherit their
parent's owner.  The fixed-capacity ``merge_padded`` of the distributed
path comes with that path.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.gaussians import Gaussians


def dedupe_mask(g: Gaussians, part_id: int):
    return g.active & (g.owner == part_id)


def merge_partitions(parts: Sequence[Gaussians],
                     part_ids: Sequence[int] = None) -> Gaussians:
    """Concatenate the owner-deduped gaussians of every partition, in
    partition order, each compacted by boolean indexing (on the parts'
    device)."""
    if part_ids is None:
        part_ids = range(len(parts))
    fields = {k: [] for k in Gaussians._fields}
    for pid, g in zip(part_ids, parts):
        keep = dedupe_mask(g, pid)
        for k in Gaussians._fields:
            fields[k].append(getattr(g, k)[keep])
    return Gaussians(**{k: torch.cat(v) for k, v in fields.items()})
