"""Mixed-precision dtype policy: bf16 tables, f32 accumulators.

Port of ``repro.core.dtypes``.  One knob — ``dtype_policy`` ("f32" |
"bf16", default "f32"):

  * "f32"   everything stays float32; ``cast_tables`` returns its input
            object untouched.
  * "bf16"  the per-tile (T, K, F) kernel feature blocks and the
            distributed step's per-splat wire tables are stored in
            bfloat16 (``cast_tables`` before the "part" all-gather, so its
            payload and its reduce-scatter transpose halve); the
            compositor promotes them back to float32 at entry
            (kernels/ops.rasterize_tiles) and accumulates in float32, and
            the loss, its psums and the Adam state stay float32.
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
        return tree.to(table_dtype(policy)) \
            if tree.dtype == torch.float32 else tree
    if isinstance(tree, dict):
        return {k: cast_tables(v, policy) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_tables(v, policy) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_tables(v, policy) for v in tree)
    return tree


def table_dtype(policy: str) -> torch.dtype:
    """The storage / wire dtype feature tables are held in under
    ``policy``."""
    check_policy(policy)
    return torch.bfloat16 if policy == "bf16" else torch.float32


def to_f32(tree):
    """Promote the bfloat16 tensors of ``tree`` (nested as ``cast_tables``
    walks it) back to float32: the compute side of the boundary.  Returns
    its input object untouched when nothing is bfloat16 (so under the
    "f32" policy)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32) if tree.dtype == torch.bfloat16 \
            else tree
    if isinstance(tree, dict):
        out = {k: to_f32(v) for k, v in tree.items()}
        return tree if all(out[k] is tree[k] for k in tree) else out
    if isinstance(tree, (tuple, list)):
        vals = [to_f32(v) for v in tree]
        if all(a is b for a, b in zip(vals, tree)):
            return tree
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return tree
