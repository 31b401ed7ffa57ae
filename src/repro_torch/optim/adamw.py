"""AdamW with bf16 params / fp32 moments, global-norm clipping.

Port of ``repro.optim.adamw``: the same arithmetic, leaf by leaf in
float32 (bias corrections ``1 - b ** step`` in float32, the clip
``min(1, grad_clip / max(|g|, 1e-12))``, weight decay on every leaf), the
result cast back to each parameter's dtype.

Unlike the reference (a pure function under ``jit``), ``adamw_update``
writes the new parameters and moments into the given tensors: a step at a
published size then holds one copy of the parameters and of ``m`` and
``v`` (a 3B-parameter model's moments are 24 GB), not two.  Leaves are
visited in ``runtime.checkpoint.tree_flatten`` order (sorted dict keys, as
``jax.tree.leaves``), which fixes ``global_norm``'s summation order.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.runtime.checkpoint import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params):
    """float32 zero moments shaped like ``params``, a 0-dim int32 step."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves, _ = tree_flatten(params)
    dev = leaves[0].device if leaves else None
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree):
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree_flatten(tree)[0])
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """Returns (params, state, stats); grads may be bf16 or fp32.

    The parameters and ``state``'s moments are updated IN PLACE and
    returned; the step counter is a new tensor.  ``lr_scale`` is a float or
    a 0-dim float32 tensor."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    flat_p, tdef = tree_flatten(params)
    flat_g, tg = tree_flatten(grads)
    flat_m, tm = tree_flatten(state["m"])
    flat_v, tv = tree_flatten(state["v"])
    if not str(tdef) == str(tg) == str(tm) == str(tv):
        raise ValueError("adamw_update: params, grads and moments differ in "
                         "structure")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        # the reference's expression, one rounding per operation; the
        # temporaries die as soon as they are used
        g = g.to(torch.float32) * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        denom = torch.sqrt(v / bc2).add_(cfg.eps)
        delta = (m / bc1).div_(denom)
        del denom
        p32 = p.to(torch.float32)
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32.sub_(lr * delta))
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm}
