"""Deterministic synthetic LM token streams with sharded loading.

Port of ``repro.data.tokens``: the numpy recurrence is a copy of the
reference's (int64), so the stream is bit-equal to it for every (seed,
step, shard, n_shards); only the return differs -- int32 tensors on
``device``.

Each global step's batch is a pure function of (seed, step, shard), so every
data-parallel shard materialises exactly its slice with no coordination, any
shard can be replayed after a failure (a checkpoint stores only the step
counter), and re-sharding onto a different width keeps the stream identical.

The stream is learnable, not uniform noise: tokens follow a per-document
affine recurrence t[i+1] = (a * t[i] + b) mod vocab_eff with document-id-
dependent (a, b) -- a next-token structure a transformer fits quickly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import check_device


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    vocab_eff: int = 0     # 0 -> min(vocab, 32768)

    def _veff(self):
        return self.vocab_eff or min(self.vocab, 32768)

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1,
              device="cuda"):
        """-> {tokens, labels}: int32 (global_batch / n_shards, seq) tensors
        on ``device``, this shard's rows of the global batch."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        dev = check_device(device)
        rows = self.global_batch // n_shards
        veff = self._veff()
        row0 = shard * rows
        doc = (np.int64(self.seed) * 1_000_003
               + np.int64(step) * self.global_batch
               + row0 + np.arange(rows, dtype=np.int64))
        # per-doc affine params (odd multiplier -> full period)
        a = (doc * 2654435761 % (veff - 3)) * 2 + 3
        b = doc * 40503 % veff
        t0 = doc * 9176 % veff
        toks = np.empty((rows, self.seq + 1), np.int64)
        toks[:, 0] = t0
        for i in range(self.seq):
            toks[:, i + 1] = (a * toks[:, i] + b) % veff
        toks = toks % veff
        return {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(dev),
        }
