"""Mixed-precision dtype policy: bf16 tables, f32 accumulators.

Port of ``repro.core.dtypes``.  One knob — ``dtype_policy`` ("f32" |
"bf16", default "f32"):

  * "f32"   everything stays float32; ``cast_tables`` returns its input
            object untouched.
  * "bf16"  the per-tile (T, K, F) kernel feature blocks are stored in
            bfloat16; the compositor promotes them back to float32 at entry
            (kernels/ops.rasterize_tiles) and accumulates in float32.
"""

from __future__ import annotations

import torch

#: supported dtype policies, in ladder order (f32 is the parity oracle)
POLICIES = ("f32", "bf16")


def check_policy(policy: str) -> str:
    """Validate (and return) a dtype policy; loud on unknown values."""
    if policy not in POLICIES:
        raise ValueError(
            f"unknown dtype_policy {policy!r}; expected one of {POLICIES}")
    return policy


def cast_tables(tree, policy: str):
    """Cast the float32 tensors of ``tree`` (a tensor, or a tuple / list /
    dict of them, nested) to the policy's storage dtype.  Identity under
    "f32"; non-f32 leaves (bool masks, int ids) pass through unchanged."""
    check_policy(policy)
    if policy == "f32":
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.bfloat16) if tree.dtype == torch.float32 \
            else tree
    if isinstance(tree, dict):
        return {k: cast_tables(v, policy) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_tables(v, policy) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_tables(v, policy) for v in tree)
    return tree
