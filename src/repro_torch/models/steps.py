"""Serve steps: prefill + decode, and the decode caches' shapes.

The serving half of the reference's ``repro.models.steps``.  The steps run
under ``torch.inference_mode()``.  The decode step writes each token's K/V
row and SSM state into the caches in place (see ``decoder.decoder_decode``)
and returns them.  The reference's PartitionSpecs (``cache_pspecs``,
``input_pspecs``) are not ported: the port runs a model on one card.
"""

from __future__ import annotations

import torch

from repro_torch import check_device
from repro_torch.models import decoder as dec
from repro_torch.models.spec import ModelSpec

#: whisper encoder frames: the cross-attention cache length of a decode cache
ENC_FRAMES = 1500


def make_prefill_step(spec: ModelSpec, kv_chunk: int = 1024):
    @torch.inference_mode()
    def prefill(params, batch):
        """batch: tokens (B, S) [+ frames (B, S, fd) | patches (B, npre, fd)]
        -> (logits at the last position (B, 1, Vp), stacked caches)."""
        tokens = batch["tokens"]
        dev = tokens.device
        enc_h, prefix_len = None, 0
        if spec.family == "encdec":
            enc_h = dec.encoder_forward(spec, params, batch["frames"])
            x = dec.embed_tokens(spec, params, tokens,
                                 torch.arange(tokens.shape[1], device=dev))
        elif spec.family == "vlm":
            pre = batch["patches"].to(params["embed"].dtype) @ params["frontend_proj"]
            x = torch.cat([pre, dec.embed_tokens(spec, params, tokens)], dim=1)
            prefix_len = spec.n_prefix_tokens
        else:
            x = dec.embed_tokens(spec, params, tokens)
        h, _, caches = dec.decoder_forward(
            spec, params, x, positions=torch.arange(x.shape[1], device=dev),
            prefix_len=prefix_len, want_cache=True, kv_chunk=kv_chunk,
            enc_h=enc_h,
        )
        logits = dec.lm_logits(spec, params, h[:, -1:, :])
        return logits, caches

    return prefill


def make_decode_step(spec: ModelSpec):
    @torch.inference_mode()
    def decode(params, caches, tokens, pos: int):
        """tokens: (B, 1) int; pos: current length -> (next token (B, 1)
        int32, caches)."""
        dev = tokens.device
        x = dec.embed_tokens(spec, params, tokens, torch.full((1,), pos, device=dev))
        h, caches = dec.decoder_decode(spec, params, x, caches, pos)
        logits = dec.lm_logits(spec, params, h).float()
        logits = logits + dec.vocab_mask_bias(spec, device=dev)[None, None, :]
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, caches

    return decode


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def cache_len(spec: ModelSpec, seq: int) -> int:
    if spec.swa_window is not None:
        return min(spec.swa_window, seq)
    return seq


def cache_specs(spec: ModelSpec, batch: int, seq: int, dtype=torch.bfloat16):
    """``meta``-tensor tree of decode caches (stacked over superblocks)."""
    nsb = spec.n_superblocks
    Hkv, hd = spec.padded_n_kv, spec.hd
    Lc = cache_len(spec, seq)

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    out = {}
    for s in range(spec.period):
        if spec.is_attn_slot(s):
            c = {
                "k": meta((nsb, batch, Lc, Hkv, hd)),
                "v": meta((nsb, batch, Lc, Hkv, hd)),
            }
            if spec.family == "encdec":
                c["cross_k"] = meta((nsb, batch, ENC_FRAMES, Hkv, hd))
                c["cross_v"] = meta((nsb, batch, ENC_FRAMES, Hkv, hd))
        else:
            cfg = spec.ssm
            di = cfg.d_inner(spec.d_model)
            nh = cfg.n_heads(spec.d_model)
            c = {
                "ssm": meta((nsb, batch, nh, cfg.head_dim, cfg.d_state),
                            torch.float32),
                "conv": meta((nsb, batch, 3, di + 2 * cfg.d_state)),
            }
        out[f"slot{s}"] = c
    return out


def zeros_caches(spec: ModelSpec, batch: int, seq: int, *, device="cuda",
                 dtype=torch.bfloat16):
    """Zero decode caches of ``cache_specs``' shapes and dtypes on ``device``."""
    dev = check_device(device)
    return {slot: {name: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                   for name, t in c.items()}
            for slot, c in cache_specs(spec, batch, seq, dtype).items()}
