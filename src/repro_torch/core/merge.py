"""Global reconstruction: merge per-partition splats (paper §II step 6).

Port of ``repro.core.merge`` (``dedupe_mask``, ``merge_partitions``).  A
partition contributes only the gaussians it owns (``owner == part_id``):
ghosts are the neighbour's responsibility, so every source gaussian appears
exactly once in the merged scene; densified children inherit their
parent's owner.  ``merge_padded`` is the fixed-capacity merge of the
distributed path.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def merge_padded(parts: Sequence[Gaussians], part_ids: Sequence[int] = None,
                 capacity: Optional[int] = None) -> Gaussians:
    """Fixed-capacity merge: capacity = the sum of the partitions'
    capacities (or ``capacity``, zero-padded up to it); deduped slots are
    deactivated instead of compacted away."""
    if part_ids is None:
        part_ids = list(range(len(parts)))
    cat = {k: torch.cat([getattr(g, k) for g in parts])
           for k in Gaussians._fields}
    cat["active"] = torch.cat([dedupe_mask(g, pid)
                               for g, pid in zip(parts, part_ids)])
    out = Gaussians(**cat)
    if capacity is not None and capacity != out.capacity:
        if capacity < out.capacity:
            raise ValueError(f"capacity {capacity} < the {out.capacity} "
                             "slots of the partitions")
        pad = capacity - out.capacity
        out = Gaussians(*[
            torch.cat([f, f.new_zeros((pad,) + tuple(f.shape[1:]))])
            for f in out])
    return out
