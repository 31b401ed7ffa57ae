"""Model forward passes: train/prefill forward, single-token decode, enc-dec.

The layer stack is a loop over *superblocks* (see spec.py): each superblock
applies ``period`` slots whose types (attention / mamba / MLP / MoE) are
static Python; superblock ``i``'s weights are ``params["sb"][slot][name][i]``
(the reference scans over the same stacked leaves), views from one
``unbind`` a leaf, so their gradients flow back into one stacked gradient
a leaf.  Prefill caches come back stacked over superblocks, ``(nsb, …)``,
as the reference returns them.  ``remat=True`` wraps each superblock (and
each encoder layer) in ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): when autograd records, the backward recomputes the
block's activations instead of keeping them.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.spec import ModelSpec


def _unstack(tree, n: int):
    """A tree of leaves stacked over ``n`` superblocks -> ``n`` trees of
    views (no copy; one ``unbind`` a leaf)."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for tree_i, part in zip(out, parts):
            tree_i[k] = part
    return out


def _remat(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    autograd is recording (the reference's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def sinusoidal_pe(positions, d_model: int, dtype=torch.float32):
    """positions: (S,) -> (S, d_model) fixed sinusoidal embeddings."""
    half = d_model // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / half)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def embed_tokens(spec: ModelSpec, params, tokens, positions=None):
    x = params["embed"][tokens]
    if spec.name.startswith("paligemma"):
        # gemma embed scaling, the scale rounded to x's dtype first
        x = x * torch.tensor(spec.d_model**0.5, dtype=x.dtype)
    if spec.rope_theta == 0.0 and positions is not None:
        # no RoPE (whisper): absolute sinusoidal positions on the decoder side
        x = x + sinusoidal_pe(positions, spec.d_model, x.dtype)[None]
    return x


def lm_logits(spec: ModelSpec, params, x):
    if spec.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def vocab_mask_bias(spec: ModelSpec, dtype=torch.float32, device="cuda"):
    """Additive bias masking padded vocab entries out of the softmax."""
    idx = torch.arange(spec.padded_vocab, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(idx < spec.vocab, zero, L.NEG_INF).to(dtype)


# ---------------------------------------------------------------------------
# Superblock bodies
# ---------------------------------------------------------------------------


def _apply_slot_train(spec: ModelSpec, slot: int, x, sp, positions, prefix_len,
                      kv_chunk, want_cache, enc_h=None):
    """One slot (layer) of a superblock, training/prefill mode.

    Returns (x, aux_loss, cache_or_None).
    """
    aux = 0.0
    cache = None
    if spec.is_attn_slot(slot):
        h = L.apply_norm(spec, x, sp["ln_attn"])
        o, kv = L.attention_block(
            spec, h, sp["attn"], positions=positions, prefix_len=prefix_len,
            kv_chunk=kv_chunk,
        )
        if want_cache:
            cache = {"k": kv[0], "v": kv[1]}
        x = x + o
        if "cross" in sp:
            assert enc_h is not None
            B, Se, _ = enc_h.shape
            Hkv, hd = spec.padded_n_kv, spec.hd
            ck = (enc_h @ sp["cross"]["wk"]).reshape(B, Se, Hkv, hd)
            cv = (enc_h @ sp["cross"]["wv"]).reshape(B, Se, Hkv, hd)
            h = L.apply_norm(spec, x, sp["ln_cross"])
            x = x + L.cross_attention_block(spec, h, sp["cross"], (ck, cv))
            if want_cache:
                cache = dict(cache or {}, cross_k=ck, cross_v=cv)
    else:
        h = L.apply_norm(spec, x, sp["ln_ssm"])
        o, ssm_state = L.mamba2_block(spec, h, sp["ssm"])
        if want_cache:
            cache = {"ssm": ssm_state}
        x = x + o
    if "moe" in sp:
        h = L.apply_norm(spec, x, sp["ln_mlp"])
        o, aux = L.moe_block(spec, h, sp["moe"])
        x = x + o
    elif "mlp" in sp:
        h = L.apply_norm(spec, x, sp["ln_mlp"])
        x = x + L.mlp_block(spec, h, sp["mlp"])
    return x, aux, cache


def decoder_forward(
    spec: ModelSpec,
    params,
    x,
    *,
    positions,
    prefix_len: int = 0,
    kv_chunk: int = 1024,
    remat: bool = True,
    want_cache: bool = False,
    enc_h=None,
):
    """Run the decoder stack. x: (B, S, D) embedded inputs.

    Returns (hidden (B,S,D), aux_loss, caches) — caches stacked per slot over
    superblocks when want_cache.
    """

    def superblock(x, sb_params):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = {}
        for s in range(spec.period):
            x, a, cache = _apply_slot_train(
                spec, s, x, sb_params[f"slot{s}"], positions, prefix_len,
                kv_chunk, want_cache, enc_h,
            )
            aux_total = aux_total + a
            if cache is not None:
                caches[f"slot{s}"] = cache
        return x, aux_total, caches

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_sb = []
    for sb_params in _unstack(params["sb"], spec.n_superblocks):
        x, a, caches = _remat(superblock, remat, x, sb_params)
        aux = aux + a
        per_sb.append(caches)
    stacked = {
        slot: {name: torch.stack([c[slot][name] for c in per_sb])
               for name in per_sb[0][slot]}
        for slot in per_sb[0]
    }
    x = L.apply_norm(spec, x, params["final_norm"])
    return x, aux, stacked


def _apply_slot_decode(spec: ModelSpec, slot: int, x, sp, cache, pos):
    """One slot of a superblock, decode mode; ``cache`` holds this
    superblock's views of the stacked caches, updated in place."""
    if spec.is_attn_slot(slot):
        h = L.apply_norm(spec, x, sp["ln_attn"])
        self_cache = {"k": cache["k"], "v": cache["v"]}
        o, _ = L.attention_decode_block(spec, h, sp["attn"], self_cache, pos)
        x = x + o
        if "cross" in sp:
            h = L.apply_norm(spec, x, sp["ln_cross"])
            x = x + L.cross_attention_block(
                spec, h, sp["cross"], (cache["cross_k"], cache["cross_v"])
            )
    else:
        h = L.apply_norm(spec, x, sp["ln_ssm"])
        o, new_state = L.mamba2_decode_block(spec, h, sp["ssm"], cache)
        for name, t in new_state.items():
            cache[name].copy_(t)
        x = x + o
    if "moe" in sp:
        h = L.apply_norm(spec, x, sp["ln_mlp"])
        o, _ = L.moe_decode_block(spec, h, sp["moe"])
        x = x + o
    elif "mlp" in sp:
        h = L.apply_norm(spec, x, sp["ln_mlp"])
        x = x + L.mlp_block(spec, h, sp["mlp"])
    return x


def decoder_decode(spec: ModelSpec, params, x, caches, pos: int):
    """Single-token decode. x: (B, 1, D); caches: per-slot stacked trees,
    updated in place.

    Returns (hidden (B,1,D), caches).
    """
    nsb = spec.n_superblocks
    for sb_params, sb_caches in zip(_unstack(params["sb"], nsb),
                                    _unstack(caches, nsb)):
        for s in range(spec.period):
            key = f"slot{s}"
            x = _apply_slot_decode(spec, s, x, sb_params[key], sb_caches[key], pos)
    x = L.apply_norm(spec, x, params["final_norm"])
    return x, caches


# ---------------------------------------------------------------------------
# Encoder (whisper) — bidirectional transformer over frame embeddings
# ---------------------------------------------------------------------------


def encoder_forward(spec: ModelSpec, params, frames, *, remat: bool = True):
    """frames: (B, S_f, frontend_dim) stub embeddings -> (B, S_f, D)."""
    x = frames.to(params["frontend_proj"].dtype) @ params["frontend_proj"]
    S = x.shape[1]
    # fixed sinusoidal positions
    x = x + sinusoidal_pe(torch.arange(S, device=x.device), spec.d_model,
                          x.dtype)[None]
    Hq, Hkv, hd = spec.padded_n_q, spec.padded_n_kv, spec.hd

    def block(x, lp):
        h = L.apply_norm(spec, x, lp["ln_attn"])
        B, S_, _ = h.shape
        q = (h @ lp["attn"]["wq"]).reshape(B, S_, Hq, hd)
        k = (h @ lp["attn"]["wk"]).reshape(B, S_, Hkv, hd)
        v = (h @ lp["attn"]["wv"]).reshape(B, S_, Hkv, hd)
        o = L.flash_attention(q, k, v, causal=False)
        x = x + o.reshape(B, S_, Hq * hd) @ lp["attn"]["wo"]
        h = L.apply_norm(spec, x, lp["ln_mlp"])
        return x + L.mlp_block(spec, h, lp["mlp"])

    for lp in _unstack(params["encoder"], spec.enc_layers):
        x = _remat(block, remat, x, lp)
    return L.apply_norm(spec, x, params["enc_final_norm"])
