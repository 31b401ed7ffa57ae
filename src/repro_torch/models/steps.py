"""Train / serve step builders, and the shapes of their inputs per cell.

Port of ``repro.models.steps``.  Shapes (the reference's assignment):

  train_4k     seq 4096,  global_batch 256   -> train_step
  prefill_32k  seq 32768, global_batch 32    -> prefill_step (serve)
  decode_32k   seq 32768 (KV cache), batch 128 -> decode_step (serve)
  long_500k    seq 524288 (cache), batch 1   -> decode_step, sub-quadratic only

The train step runs with autograd enabled and updates the parameters and
the AdamW moments in place (see ``optim.adamw``); the serve steps run under
``torch.inference_mode()``.  The decode step writes each token's K/V row
and SSM state into the caches in place (see ``decoder.decoder_decode``)
and returns them.  ``opt_state_specs``, ``cache_specs`` and
``input_specs`` give ``meta``-tensor trees (the reference's
``ShapeDtypeStruct`` trees).  The reference's shardings and
PartitionSpecs (``opt_state_shardings``, ``input_pspecs``,
``cache_pspecs``, ``batch_axes``, ``_pad_batch_axes``) are not ported: the
port runs a model on one card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import check_device
from repro_torch.models import decoder as dec
from repro_torch.models.params import param_specs
from repro_torch.models.spec import ModelSpec
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, make_schedule)
from repro_torch.runtime.checkpoint import tree_flatten, tree_map

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(spec: ModelSpec, params, hidden, labels, loss_mask=None):
    """Mean next-token NLL over float32 logits (padded vocab masked out).
    The gold logit is a gather: it equals the reference's one-hot einsum
    bit for bit (every other product is +-0) without a (B, S, Vp) one-hot."""
    logits = dec.lm_logits(spec, params, hidden).to(torch.float32)
    logits = logits + dec.vocab_mask_bias(spec, device=logits.device)[None, None, :]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if loss_mask is not None:
        nll = nll * loss_mask
        return nll.sum() / torch.clamp(loss_mask.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# Forward passes per family
# ---------------------------------------------------------------------------


def forward_train(spec: ModelSpec, params, batch, *, remat=True, kv_chunk=1024):
    """Returns (loss, aux) for one (micro)batch dict."""
    tokens = batch["tokens"]
    dev = tokens.device
    if spec.family == "encdec":
        enc_h = dec.encoder_forward(spec, params, batch["frames"], remat=remat)
        positions = torch.arange(tokens.shape[1], device=dev)
        x = dec.embed_tokens(spec, params, tokens, positions)
        h, aux, _ = dec.decoder_forward(
            spec, params, x, positions=positions, remat=remat,
            kv_chunk=kv_chunk, enc_h=enc_h,
        )
        return lm_loss(spec, params, h, batch["labels"]), aux
    if spec.family == "vlm":
        pre = batch["patches"].to(params["embed"].dtype) @ params["frontend_proj"]
        x = torch.cat([pre, dec.embed_tokens(spec, params, tokens)], dim=1)
        h, aux, _ = dec.decoder_forward(
            spec, params, x, positions=torch.arange(x.shape[1], device=dev),
            prefix_len=spec.n_prefix_tokens, remat=remat, kv_chunk=kv_chunk,
        )
        h_text = h[:, pre.shape[1]:, :]
        return lm_loss(spec, params, h_text, batch["labels"]), aux
    x = dec.embed_tokens(spec, params, tokens)
    h, aux, _ = dec.decoder_forward(
        spec, params, x, positions=torch.arange(x.shape[1], device=dev),
        remat=remat, kv_chunk=kv_chunk,
    )
    return lm_loss(spec, params, h, batch["labels"]), aux


# ---------------------------------------------------------------------------
# Train step (with gradient accumulation + optional grad compression)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    optimizer: AdamWConfig = AdamWConfig()
    n_microbatches: int = 1
    aux_weight: float = 0.01          # MoE load-balance loss weight
    compression: str = "none"         # none | bf16 | int8
    schedule: str = "cosine"
    total_steps: int = 10_000
    remat: bool = True
    kv_chunk: int = 1024


def make_train_step(spec: ModelSpec, cfg: TrainCfg = TrainCfg()):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  The learning-rate multiplier is the schedule at the step
    count BEFORE this step's increment (so the first step has lr_scale 0
    under a warmup and changes no parameter), as in the reference.  The
    parameters and moments are updated in place; metrics are 0-dim float32
    tensors: loss, aux, grad_norm, lr_scale."""
    sched = make_schedule(
        cfg.schedule if cfg.schedule != "auto" else spec.lr_schedule, cfg.total_steps
    )

    def value_and_grad(leaves, treedef, mb):
        """(loss, aux, d(loss + aux_weight * aux)/d leaf for every leaf)."""
        with torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in leaves]
            loss, aux = forward_train(spec, treedef.unflatten(ps), mb,
                                      remat=cfg.remat, kv_chunk=cfg.kv_chunk)
            grads = torch.autograd.grad(loss + cfg.aux_weight * aux, ps,
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), aux.detach(), grads

    def train_step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        nmb = cfg.n_microbatches
        if nmb == 1:
            loss, aux, grads = value_and_grad(leaves, treedef, batch)
        else:
            def split(x):
                return x.reshape((nmb, x.shape[0] // nmb) + x.shape[1:])

            mbs = {k: split(x) for k, x in batch.items()}
            dev = leaves[0].device
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(nmb):
                l_i, a_i, g_i = value_and_grad(
                    leaves, treedef, {k: x[i] for k, x in mbs.items()})
                grads = [a + b.to(torch.float32) / nmb for a, b in zip(grads, g_i)]
                loss = loss + l_i / nmb
                aux = aux + a_i / nmb
                del g_i

        with torch.no_grad():
            grads, new_err, _ = compress_grads(
                treedef.unflatten(list(grads)), cfg.compression,
                opt_state.get("compress_err"))
            lr_scale = sched(opt_state["adam"]["step"])
            new_params, new_adam, stats = adamw_update(
                cfg.optimizer, params, grads, opt_state["adam"], lr_scale
            )
        new_opt = {"adam": new_adam}
        if cfg.compression == "int8":
            new_opt["compress_err"] = new_err
        metrics = {"loss": loss, "aux": aux, "grad_norm": stats["grad_norm"],
                   "lr_scale": lr_scale}
        return new_params, new_opt, metrics

    return train_step


def opt_state_specs(spec: ModelSpec, cfg: TrainCfg = TrainCfg()):
    """``meta``-tensor tree of ``init_opt_state``'s output."""
    ps = param_specs(spec)
    f32 = lambda s: _meta(s.shape, torch.float32)
    st = {
        "adam": {
            "m": tree_map(f32, ps),
            "v": tree_map(f32, ps),
            "step": _meta((), torch.int32),
        }
    }
    if cfg.compression == "int8":
        st["compress_err"] = tree_map(f32, ps)
    return st


def init_opt_state(spec: ModelSpec, params, cfg: TrainCfg = TrainCfg()):
    st = {"adam": adamw_init(params)}
    if cfg.compression == "int8":
        st["compress_err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params,
        )
    return st


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------

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

    out = {}
    for s in range(spec.period):
        if spec.is_attn_slot(s):
            c = {
                "k": _meta((nsb, batch, Lc, Hkv, hd), dtype),
                "v": _meta((nsb, batch, Lc, Hkv, hd), dtype),
            }
            if spec.family == "encdec":
                c["cross_k"] = _meta((nsb, batch, ENC_FRAMES, Hkv, hd), dtype)
                c["cross_v"] = _meta((nsb, batch, ENC_FRAMES, Hkv, hd), dtype)
        else:
            cfg = spec.ssm
            di = cfg.d_inner(spec.d_model)
            nh = cfg.n_heads(spec.d_model)
            c = {
                "ssm": _meta((nsb, batch, nh, cfg.head_dim, cfg.d_state),
                             torch.float32),
                "conv": _meta((nsb, batch, 3, di + 2 * cfg.d_state), dtype),
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


# ---------------------------------------------------------------------------
# Input specs per shape cell
# ---------------------------------------------------------------------------


def input_specs(spec: ModelSpec, shape_name: str):
    """``meta``-tensor stand-ins for every model input of a shape cell."""
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    tok = lambda b, s: _meta((b, s), torch.int32)
    if sh["kind"] in ("train", "prefill"):
        names = ("tokens", "labels") if sh["kind"] == "train" else ("tokens",)
        batch = {n: tok(B, S) for n in names}
        if spec.family == "encdec":
            batch["frames"] = _meta((B, S, spec.frontend_dim), torch.bfloat16)
        if spec.family == "vlm":
            npre = spec.n_prefix_tokens
            batch = {n: tok(B, S - npre) for n in names}
            batch["patches"] = _meta((B, npre, spec.frontend_dim), torch.bfloat16)
        return {"batch": batch}
    # decode
    return {
        "caches": cache_specs(spec, B, S),
        "tokens": tok(B, 1),
        "pos": _meta((), torch.int32),
    }
