"""Parameter trees: shapes, logical sharding axes, initialisation.

Every leaf is described once by a ``PDef(shape, logical, scale)``; from that we
derive (a) ``meta``-device tensor trees (shapes and dtypes, no storage: the
counterpart of the reference's ``ShapeDtypeStruct`` trees) and (b) real
initialised params.  The reference's ``param_pspecs`` / ``param_shardings``
(pjit shardings) are not ported: the port runs a model on one card.

Layout: ``params["sb"]["slot{i}"][name]`` — tensors stacked over superblocks
(leading "layers" dim, looped over), plus top-level ``embed`` / ``head`` /
``final_norm`` / encoder stack / frontend projector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import check_device
from repro_torch.models.spec import ModelSpec

PARAM_DTYPE = torch.bfloat16


class PDef:
    __slots__ = ("shape", "logical", "scale")

    def __init__(self, shape, logical, scale=0.02):
        assert len(shape) == len(logical)
        self.shape = tuple(int(s) for s in shape)
        self.logical = tuple(logical)
        self.scale = scale


def _norm_defs(spec: ModelSpec, prefix_dims=(), prefix_log=()):
    d = {"w": PDef(prefix_dims + (spec.d_model,), prefix_log + ("embed_act",), 0.0)}
    if spec.norm == "layernorm":
        d["b"] = PDef(prefix_dims + (spec.d_model,), prefix_log + ("embed_act",), 0.0)
    return d


def _attn_defs(spec: ModelSpec, L, cross=False):
    D, hd = spec.d_model, spec.hd
    Hq, Hkv = spec.padded_n_q, spec.padded_n_kv
    res_scale = 0.02 / np.sqrt(2 * spec.n_layers)
    d = {
        "wq": PDef((L, D, Hq * hd), ("layers", "embed", "q_heads")),
        "wk": PDef((L, D, Hkv * hd), ("layers", "embed", "kv_heads")),
        "wv": PDef((L, D, Hkv * hd), ("layers", "embed", "kv_heads")),
        "wo": PDef((L, Hq * hd, D), ("layers", "q_heads", "embed"), res_scale),
    }
    if spec.qkv_bias and not cross:
        d["bq"] = PDef((L, Hq * hd), ("layers", "q_heads"), 0.0)
        d["bk"] = PDef((L, Hkv * hd), ("layers", "kv_heads"), 0.0)
        d["bv"] = PDef((L, Hkv * hd), ("layers", "kv_heads"), 0.0)
    return d


def _mlp_defs(spec: ModelSpec, L):
    D, F = spec.d_model, spec.d_ff
    res_scale = 0.02 / np.sqrt(2 * spec.n_layers)
    d = {
        "w1": PDef((L, D, F), ("layers", "embed", "ff")),
        "w2": PDef((L, F, D), ("layers", "ff", "embed"), res_scale),
    }
    if spec.act in ("silu", "geglu"):
        d["w3"] = PDef((L, D, F), ("layers", "embed", "ff"))
    return d


def _moe_defs(spec: ModelSpec, L):
    D, F, E = spec.d_model, spec.d_ff, spec.moe.n_experts
    res_scale = 0.02 / np.sqrt(2 * spec.n_layers)
    d = {
        "router": PDef((L, D, E), ("layers", "embed", None)),
        "w1": PDef((L, E, D, F), ("layers", "experts", "embed", "ff")),
        "w2": PDef((L, E, F, D), ("layers", "experts", "ff", "embed"), res_scale),
    }
    if spec.act in ("silu", "geglu"):
        d["w3"] = PDef((L, E, D, F), ("layers", "experts", "embed", "ff"))
    return d


def _mamba_defs(spec: ModelSpec, L):
    D = spec.d_model
    cfg = spec.ssm
    di = cfg.d_inner(D)
    nh = cfg.n_heads(D)
    ds = cfg.d_state
    conv_dim = di + 2 * ds
    res_scale = 0.02 / np.sqrt(2 * spec.n_layers)
    return {
        "in_proj": PDef((L, D, 2 * di + 2 * ds + nh), ("layers", "embed", "ssm_heads")),
        "conv": PDef((L, 4, conv_dim), ("layers", "conv", "ssm_heads"), 0.1),
        "conv_b": PDef((L, conv_dim), ("layers", "ssm_heads"), 0.0),
        "A_log": PDef((L, nh), ("layers", "ssm_heads"), -1.0),   # init exp(A_log)~e^-1
        "dt_bias": PDef((L, nh), ("layers", "ssm_heads"), 0.0),
        "D_skip": PDef((L, nh), ("layers", "ssm_heads"), 0.0),
        "norm_w": PDef((L, di), ("layers", "ssm_heads"), 0.0),
        "out_proj": PDef((L, di, D), ("layers", "ssm_heads", "embed"), res_scale),
    }


def _slot_defs(spec: ModelSpec, slot: int, L: int):
    d = {}
    is_attn = spec.is_attn_slot(slot)
    if is_attn:
        d["ln_attn"] = _norm_defs(spec, (L,), ("layers",))
        d["attn"] = _attn_defs(spec, L)
    else:
        d["ln_ssm"] = _norm_defs(spec, (L,), ("layers",))
        d["ssm"] = _mamba_defs(spec, L)
    if spec.family == "encdec":
        d["ln_cross"] = _norm_defs(spec, (L,), ("layers",))
        d["cross"] = _attn_defs(spec, L, cross=True)
    if spec.family == "ssm":
        return d  # mamba2 blocks have no separate FFN
    # layer index of this slot in superblock sb is sb*period + slot; moe-ness
    # depends only on slot when period % moe.every == 0 (asserted in configs).
    if spec.moe is not None and spec.is_moe_slot(slot, slot):
        d["ln_mlp"] = _norm_defs(spec, (L,), ("layers",))
        d["moe"] = _moe_defs(spec, L)
    elif spec.d_ff:
        d["ln_mlp"] = _norm_defs(spec, (L,), ("layers",))
        d["mlp"] = _mlp_defs(spec, L)
    return d


def param_defs(spec: ModelSpec):
    """Full PDef tree for a spec."""
    D, Vp = spec.d_model, spec.padded_vocab
    sb = {}
    for s in range(spec.period):
        sb[f"slot{s}"] = _slot_defs(spec, s, spec.n_superblocks)
    tree = {
        "embed": PDef((Vp, D), ("vocab", "embed_act")),
        "final_norm": _norm_defs(spec),
        "sb": sb,
    }
    if not spec.tie_embeddings:
        tree["head"] = PDef((D, Vp), ("embed_act", "vocab"))
    if spec.family == "encdec":
        enc = {
            "ln_attn": _norm_defs(spec, (spec.enc_layers,), ("layers",)),
            "attn": _attn_defs(spec, spec.enc_layers),
            "ln_mlp": _norm_defs(spec, (spec.enc_layers,), ("layers",)),
            "mlp": _mlp_defs(spec, spec.enc_layers),
        }
        tree["encoder"] = enc
        tree["enc_final_norm"] = _norm_defs(spec)
    if spec.frontend != "none":
        fd = spec.frontend_dim or D
        tree["frontend_proj"] = PDef((fd, D), (None, "embed_act"))
    return tree


# ---------------------------------------------------------------------------


def _map_defs(tree, fn):
    if isinstance(tree, PDef):
        return fn(tree)
    return {k: _map_defs(v, fn) for k, v in tree.items()}


def param_specs(spec: ModelSpec, dtype=PARAM_DTYPE):
    """``meta``-device tensor tree (shapes and dtypes, no allocation)."""
    return _map_defs(param_defs(spec),
                     lambda d: torch.empty(d.shape, dtype=dtype, device="meta"))


def init_params(spec: ModelSpec, generator: torch.Generator,
                dtype=PARAM_DTYPE, device="cuda"):
    """Real initialisation: each leaf drawn in float32 on the generator's
    device, in ``param_defs`` order, then cast to ``dtype`` on ``device``
    (a generator on the card draws a full-size model there; a CPU generator
    gives the same state on every device)."""
    dev = check_device(device)

    def init(d: PDef):
        if d.scale == 0.0:
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.scale == -1.0:  # A_log special init: log(uniform[1,16])
            u = torch.rand(d.shape, generator=generator,
                           device=generator.device) * 15.0 + 1.0
            return torch.log(u).to(dev, dtype)
        arr = torch.randn(d.shape, generator=generator, device=generator.device)
        return (arr * d.scale).to(dev, dtype)

    out = _map_defs(param_defs(spec), init)
    # zero out padded vocab rows & padded head columns so padding is exact
    vp, v = spec.padded_vocab, spec.vocab
    if vp > v:
        out["embed"][v:] = 0
        if "head" in out:
            out["head"][:, v:] = 0
    return out


def params_from_numpy(tree, *, device, dtype: Optional[torch.dtype] = None):
    """The reference's parameter tree (nested dicts of ``np.asarray`` of each
    leaf) -> the port's, on ``device`` (cast to ``dtype`` when given).
    bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16, which
    ``torch.from_numpy`` refuses) cross as their int16 bit patterns."""
    dev = check_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dev, dtype) if dtype is not None else t.to(dev)

    return {k: params_from_numpy(v, device=device, dtype=dtype)
            if isinstance(v, dict) else leaf(v) for k, v in tree.items()}
