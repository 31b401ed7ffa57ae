"""Gradient compression with error feedback, port of
``repro.optim.compress``.

What is modelled is the quantise -> dequantise transform a compressed
gradient all-reduce applies to each replica's contribution, plus the
error-feedback residual that carries the quantisation error into the next
step (Seide et al.).  The distributed step (``core.distributed``) applies
it after the gradients' all-reduce over ("model", "view") and before Adam.

Modes: "none" (identity, ratio 1), "bf16" (f32 -> bf16 -> f32, stateless,
ratio 2), "int8" (one symmetric scale per tensor, round half to even,
clip to [-127, 127], with error feedback; ratio 4).

"Per tensor" is the GLOBAL tensor: in the reference one jitted program
holds the whole (P, N, ...) gradient, so its ``max |g + e|`` spans every
shard.  Here each rank holds a (Pl, Nl, ...) block, so ``group=`` names
the ranks holding the other blocks and the max is all-reduced over them
(None: this rank holds the whole tensor).

``grads`` is any tree of tensors (the GS trainer's flat dict, the LM's
nested parameter dicts); the error state has the same structure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.runtime.checkpoint import tree_flatten, tree_map

#: the modes and their wire ratios (bytes of f32 over bytes on the wire)
RATIOS = {"none": 1.0, "bf16": 2.0, "int8": 4.0}


def _global_absmax(x: torch.Tensor, group) -> torch.Tensor:
    """max |x| over this rank's block and, with ``group``, every other
    rank's block of the same tensor."""
    m = x.abs().max()
    if group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return m


def _quantize_int8(g: torch.Tensor, e: torch.Tensor, group=None):
    """One tensor's int8 round trip with error feedback -> (dequantised
    gradient, new residual), both float32."""
    g = g.to(torch.float32) + e
    scale = torch.clamp(_global_absmax(g, group), min=1e-12) / 127.0
    qi = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = qi.to(torch.float32) * scale
    return deq, g - deq


def compress_grads(grads, mode: str, err_state=None, *, group=None):
    """``grads`` (a tree of tensors) -> (decompressed grads, new error
    state, wire ratio).  "none" returns ``grads`` itself; "bf16" carries no
    state (the error state passes through); "int8" starts from a zero
    residual when ``err_state`` is None.  ``group``: the process group
    over which each tensor is sharded (its int8 scale is the max over the
    group); None for a tensor held whole."""
    if mode == "none":
        return grads, err_state, RATIOS[mode]
    if mode == "bf16":
        out = tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        return out, err_state, RATIOS[mode]
    if mode == "int8":
        flat_g, treedef = tree_flatten(grads)
        if err_state is None:
            flat_e = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                      for g in flat_g]
        else:
            flat_e, tdef_e = tree_flatten(err_state)
            if str(tdef_e) != str(treedef):
                raise ValueError("compress_grads: the error state's structure "
                                 "differs from the gradients'")
        pairs = [_quantize_int8(g, e, group) for g, e in zip(flat_g, flat_e)]
        return (treedef.unflatten([d for d, _ in pairs]),
                treedef.unflatten([r for _, r in pairs]), RATIOS[mode])
    raise ValueError(mode)
