"""Core NN layers for the assigned architectures: the forward passes.

The port of ``repro.models.layers`` (the reference), in plain PyTorch:

* Attention is a *chunked online-softmax* ("flash-style") implementation: a
  loop over KV blocks carrying (max, sum, acc) in float32, which bounds the
  live logits to (B, H, S_q, kv_chunk) instead of (…, S_kv).  Scores are
  float32 whatever the inputs' dtype (the reference's
  ``preferred_element_type=float32``); the probabilities are cast to the
  values' dtype before the PV product, as there.  KV heads are repeated to
  the (padded) query-head count (GQA / MQA).
* Sliding-window attention (SWA) is the same loop with a lower band on the
  position mask; decode uses a rolling KV cache of window size.
* MoE uses per-sequence capacity dispatch (GShard-style) with a scatter-add
  into (B, E, C, D) buffers; tokens past an expert's capacity are dropped.
* Mamba2 uses the chunked SSD (state-space duality) algorithm: intra-chunk
  quadratic term + inter-chunk recurrence (a loop over chunks).

Training differentiates these forwards with autograd, except attention's
default path: ``flash_attention(impl="vjp")`` is a ``torch.autograd.Function``
whose backward is the reference's recomputing flash backward (it saves
(q, k, v, out, m, l) and recomputes each chunk's probabilities, never an
O(Sq * Skv) stash).  The reference's ``constrain_batch`` (a sharding
constraint, a no-op on one device) is not ported.  Nothing on the training
forward writes in place; the decode blocks write the new token's K/V row
into the cache in place, and the SSM decode returns its new state, as the
reference does.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.spec import ModelSpec, MoECfg, SSMCfg

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def apply_norm(spec: ModelSpec, x, p):
    if spec.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions, head_dim: int, theta: float):
    """positions: int (...,) -> cos/sin tables (..., head_dim/2), float32."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Flash-style chunked attention (training / prefill)
# ---------------------------------------------------------------------------

NEG_INF = -1e30

#: "vjp"  — the reference's custom-VJP flash attention (a recomputing
#:          backward; no O(S*S) stash): ``_FlashVJP``.
#: "scan" — the reference's plain-scan baseline (autograd through the chunk
#:          loop saves every chunk's probabilities).
#: Both share one forward; they differ only in the backward.
FLASH_IMPL = os.environ.get("REPRO_ATTN_IMPL", "vjp")


def set_flash_impl(impl: str):
    global FLASH_IMPL
    assert impl in ("vjp", "scan")
    FLASH_IMPL = impl


def _attn_mask(causal, prefix_len, window, q_pos, kv_pos):
    """Shared position mask: causal + prefix-LM bidirectional + SWA band."""
    if not causal:
        return None
    ok = kv_pos[None, :] <= q_pos[:, None]
    if prefix_len:
        bidir = (q_pos[:, None] < prefix_len) & (kv_pos[None, :] < prefix_len)
        ok = ok | bidir
    if window is not None:
        ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
    return ok


def _dot32(eq, a, b):
    """einsum with float32 products and accumulation (the reference's
    ``preferred_element_type=jnp.float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def _chunk_mask(causal, prefix_len, window, q_pos, kv_offset, lo, kv_chunk,
                Skv, dev):
    """Chunk ``[lo, lo + kv_chunk)``'s (Sq, C) mask: the position mask and
    the zero-padded tail past ``Skv``."""
    kv_idx = lo + torch.arange(kv_chunk, device=dev)
    ok = _attn_mask(causal, prefix_len, window, q_pos, kv_offset + kv_idx)
    valid = kv_idx < Skv
    return valid[None, :] if ok is None else ok & valid[None, :]


def _flash_kv(k, v, G, kv_chunk):
    """KV heads repeated to the query heads, zero-padded to whole chunks
    (the reference pads the same way) -> (k, v, number of chunks)."""
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    Skv = k.shape[1]
    nchunks = max(1, (Skv + kv_chunk - 1) // kv_chunk)
    pad = nchunks * kv_chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, nchunks


def _flash_fwd(q, k, v, causal, window, q_offset, kv_offset, kv_chunk,
               prefix_len, kv_len_mask=None):
    """The chunked online-softmax loop -> (out (B, Sq, Hq, hd) in v's dtype,
    the running max m and sum l, (B, Hq, Sq) float32)."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    k, v, nchunks = _flash_kv(k, v, Hq // Hkv, kv_chunk)
    if kv_len_mask is not None and k.shape[1] > Skv:
        kv_len_mask = F.pad(kv_len_mask, (0, k.shape[1] - Skv), value=False)

    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hq, Sq, hd), dtype=torch.float32, device=dev)
    for c in range(nchunks):
        lo = c * kv_chunk
        kcb, vcb = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
        s = _dot32("bqhd,bchd->bhqc", q, kcb) * scale
        ok = _chunk_mask(causal, prefix_len, window, q_pos, kv_offset, lo,
                         kv_chunk, Skv, dev)
        s = s.masked_fill(~ok[None, None], NEG_INF)
        if kv_len_mask is not None:
            msk = kv_len_mask[:, lo:lo + kv_chunk]
            s = s.masked_fill(~msk[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = _dot32("bhqc,bchd->bhqd", p.to(vcb.dtype), vcb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).reshape(B, Sq, Hq, hd).to(v.dtype), m, l


class _FlashVJP(torch.autograd.Function):
    """The reference's ``_flash_vjp``: the chunked forward, saving only
    (q, k, v, out, m, l); the backward recomputes each chunk's
    probabilities from the log-sum-exp (``_flash_vjp_bwd``)::

        delta = rowsum(g * out)
        p     = exp(s - lse)          (0 where masked)
        ds    = p * (dp - delta) * scale,  dp = g @ v^T
        dq   += ds @ k;   dk_c = ds^T @ q;   dv_c = p^T @ g

    all in float32, the padded tail sliced off, the GQA repeats summed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_offset, kv_chunk,
                prefix_len):
        out, m, l = _flash_fwd(q, k, v, causal, window, q_offset, kv_offset,
                               kv_chunk, prefix_len)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.cfg = (causal, window, q_offset, kv_offset, kv_chunk, prefix_len)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, window, q_offset, kv_offset, kv_chunk, prefix_len = ctx.cfg
        B, Sq, Hq, hd = q.shape
        _, Skv, Hkv, _ = k.shape
        G = Hq // Hkv
        scale = 1.0 / math.sqrt(hd)
        dev = q.device
        kr, vr, nchunks = _flash_kv(k, v, G, kv_chunk)

        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), 0.0)
        gf = g.float().transpose(1, 2)                       # (B,Hq,Sq,hd)
        of = out.float().transpose(1, 2)
        delta = (gf * of).sum(-1)                            # (B,Hq,Sq)
        qf = q.float()
        q_pos = q_offset + torch.arange(Sq, device=dev)
        dq = torch.zeros((B, Hq, Sq, hd), dtype=torch.float32, device=dev)
        dks, dvs = [], []
        for c in range(nchunks):
            lo = c * kv_chunk
            kcb, vcb = kr[:, lo:lo + kv_chunk], vr[:, lo:lo + kv_chunk]
            s = _dot32("bqhd,bchd->bhqc", q, kcb) * scale
            ok = _chunk_mask(causal, prefix_len, window, q_pos, kv_offset, lo,
                             kv_chunk, Skv, dev)
            p = torch.where(ok[None, None], torch.exp(s - lse[..., None]), 0.0)
            dp = torch.einsum("bhqd,bchd->bhqc", gf, vcb.float())
            ds = p * (dp - delta[..., None]) * scale         # (B,Hq,Sq,C)
            dq = dq + torch.einsum("bhqc,bchd->bhqd", ds, kcb.float())
            dks.append(torch.einsum("bhqc,bqhd->bchd", ds, qf))
            dvs.append(torch.einsum("bhqc,bhqd->bchd", p, gf))
        dq = dq.transpose(1, 2).to(q.dtype)
        dk = torch.cat(dks, 1)[:, :Skv]
        dv = torch.cat(dvs, 1)[:, :Skv]
        if G > 1:  # repeat_interleave's order: head h * G + j is kv head h
            dk = dk.reshape(B, Skv, Hkv, G, hd).sum(3)
            dv = dv.reshape(B, Skv, Hkv, G, hd).sum(3)
        return (dq, dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def flash_attention(
    q, k, v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=0,
    kv_offset=0,
    kv_chunk: int = 1024,
    prefix_len: int = 0,
    kv_len_mask=None,
    impl: Optional[str] = None,
):
    """Chunked online-softmax attention.

    q: (B, Sq, Hq, hd);  k, v: (B, Skv, Hkv, hd) with Hq = G * Hkv.
    ``prefix_len``: positions < prefix_len attend bidirectionally (PaliGemma
    prefix-LM); only meaningful with causal=True.
    ``kv_len_mask``: optional (B, Skv) bool validity mask (ragged caches).
    ``impl``: "vjp" (the recomputing backward, default) or "scan" (autograd
    through the loop; it saves every chunk's probabilities).  As in the
    reference, "vjp" applies only without ``kv_len_mask`` and with Python
    int offsets; otherwise autograd runs through the loop.  Returns
    (B, Sq, Hq, hd) in v's dtype.
    """
    impl = impl or FLASH_IMPL
    if impl not in ("vjp", "scan"):
        raise ValueError(f"flash_attention impl {impl!r}")
    if impl == "vjp" and kv_len_mask is None and isinstance(q_offset, int) \
            and isinstance(kv_offset, int) and torch.is_grad_enabled() \
            and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashVJP.apply(q, k, v, causal, window, q_offset, kv_offset,
                               kv_chunk, prefix_len)
    return _flash_fwd(q, k, v, causal, window, q_offset, kv_offset, kv_chunk,
                      prefix_len, kv_len_mask)[0]


def decode_attention(q, k_cache, v_cache, cache_pos, *, window: Optional[int] = None):
    """Single-token decode attention against a cache.

    q: (B, 1, Hq, hd); caches: (B, L_cache, Hkv, hd); cache_pos: int —
    number of valid entries: entries with index >= cache_pos are masked
    (for rolling SWA caches the whole buffer is valid once full).  Logits
    are grouped by kv head, (B, Hkv, G, Lc), so the cache is contracted
    without a repeated copy.
    """
    B, _, Hq, hd = q.shape
    _, Lc, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hkv, G, hd)
    s = _dot32("bhgd,bchd->bhgc", qg, k_cache) * scale
    valid = torch.arange(Lc, device=q.device) < cache_pos
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _dot32("bhgc,bchd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, Hq, hd).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope + flash / decode)
# ---------------------------------------------------------------------------


def attn_project_qkv(spec: ModelSpec, x, p, positions):
    B, S, D = x.shape
    Hq, Hkv, hd = spec.padded_n_q, spec.padded_n_kv, spec.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if spec.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, Hq, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if spec.rope_theta > 0:
        cos, sin = rope_tables(positions, hd, spec.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_block(spec: ModelSpec, x, p, *, positions, prefix_len: int = 0,
                    kv_chunk: int = 1024):
    """Full training/prefill attention. x: (B,S,D) -> (B,S,D), plus (k,v) for caching."""
    q, k, v = attn_project_qkv(spec, x, p, positions)
    o = flash_attention(
        q, k, v,
        causal=True,
        window=spec.swa_window,
        prefix_len=prefix_len,
        kv_chunk=kv_chunk,
    )
    B, S, _, _ = q.shape
    o = o.reshape(B, S, spec.padded_n_q * spec.hd)
    return o @ p["wo"], (k, v)


def attention_decode_block(spec: ModelSpec, x, p, cache, pos: int):
    """x: (B,1,D); cache: dict(k,v) (B, Lc, Hkv, hd); pos: current length.

    Writes the token's K/V row into ``cache`` in place and returns (out
    (B,1,D), cache).  SWA uses a rolling buffer (Lc = window).
    """
    B = x.shape[0]
    q, k, v = attn_project_qkv(
        spec, x, p, positions=torch.full((1,), pos, device=x.device))
    Lc = cache["k"].shape[1]
    if spec.swa_window is not None and Lc == spec.swa_window:
        slot = pos % Lc
        n_valid = min(pos + 1, Lc)
    else:
        slot = pos
        n_valid = pos + 1
    if not 0 <= slot < Lc:
        raise IndexError(f"decode position {pos} outside a cache of {Lc}")
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    o = decode_attention(q, cache["k"], cache["v"], n_valid, window=spec.swa_window)
    o = o.reshape(B, 1, spec.padded_n_q * spec.hd)
    return o @ p["wo"], cache


def cross_attention_block(spec: ModelSpec, x, p, enc_kv):
    """Enc-dec cross attention (whisper). enc_kv: (k, v) from encoder output."""
    B, S, D = x.shape
    Hq, hd = spec.padded_n_q, spec.hd
    q = (x @ p["wq"]).reshape(B, S, Hq, hd)
    k, v = enc_kv
    o = flash_attention(q, k, v, causal=False)
    return o.reshape(B, S, Hq * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_block(spec: ModelSpec, x, p):
    if spec.act == "silu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    elif spec.act == "geglu":
        h = _gelu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = _gelu(x @ p["w1"])
    return h @ p["w2"]


def _route(cfg: MoECfg, x, router):
    """Router in float32 -> (probs (B,S,E), top_p (B,S,K) renormalised,
    top_e (B,S,K))."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def moe_block(spec: ModelSpec, x, p):
    """GShard-style per-sequence capacity routing; expert-TP compute.

    x: (B, S, D).  Router in fp32.  Returns (B, S, D) plus aux load-balance loss.
    """
    cfg: MoECfg = spec.moe
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(K, int(S * K * cfg.capacity_factor / E))
    probs, top_p, top_e = _route(cfg, x, p["router"])

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * fe)

    flat_e = top_e.reshape(B, S * K)                                    # (B, N)
    # position of each routed token within its expert (per sequence)
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1                 # (B, N, E)
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]          # (B, N)
    keep = pos_in_e < C
    # overflow tokens add 0 into the last slot (weight 0) and read it back
    safe_pos = torch.where(keep, pos_in_e, C - 1)
    w = keep.to(x.dtype)
    xr = x.repeat_interleave(K, dim=1)                                  # (B, N, D)
    slot = (flat_e * C + safe_pos)[..., None].expand(B, S * K, D)
    buf = torch.zeros((B, E * C, D), dtype=x.dtype, device=x.device)
    buf = buf.scatter_add(1, slot, xr * w[..., None]).reshape(B, E, C, D)

    h1 = torch.einsum("becd,edf->becf", buf, p["w1"])
    if spec.act == "silu":
        h = F.silu(h1) * torch.einsum("becd,edf->becf", buf, p["w3"])
    else:
        h = _gelu(h1)
    yb = torch.einsum("becf,efd->becd", h, p["w2"])                     # (B,E,C,D)
    y = torch.gather(yb.reshape(B, E * C, D), 1, slot)                  # (B,N,D)
    y = y * (w * top_p.reshape(B, S * K).to(x.dtype))[..., None]
    y = y.reshape(B, S, K, D).sum(dim=2)
    return y, aux


def moe_decode_block(spec: ModelSpec, x, p):
    """Decode-time MoE (S small): dense top-k combine without capacity buffers."""
    _, top_p, top_e = _route(spec.moe, x, p["router"])
    w1 = p["w1"][top_e]  # (B,S,K,D,F)
    w2 = p["w2"][top_e]
    h1 = torch.einsum("bsd,bskdf->bskf", x, w1)
    if spec.act == "silu":
        h = F.silu(h1) * torch.einsum("bsd,bskdf->bskf", x, p["w3"][top_e])
    else:
        h = _gelu(h1)
    y = torch.einsum("bskf,bskfd->bskd", h, w2)
    aux = x.new_zeros((), dtype=torch.float32)
    return (y * top_p.to(x.dtype)[..., None]).sum(dim=2), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD — state-space duality, chunked)
# ---------------------------------------------------------------------------


def _ssm_split(cfg: SSMCfg, D, zxbcdt):
    di, ds = cfg.d_inner(D), cfg.d_state
    return torch.split(zxbcdt, [di, di + 2 * ds, cfg.n_heads(D)], dim=-1)


def mamba2_block(spec: ModelSpec, x, p):
    """Chunked SSD forward. x: (B, S, D) -> (B, S, D), final_state.

    Params: in_proj (D, 2*di + 2*ds + nh), conv (4, di + 2*ds), A_log (nh,),
    dt_bias (nh,), D_skip (nh,), norm_w (di,), out_proj (di, D).
    """
    cfg: SSMCfg = spec.ssm
    B, S, D = x.shape
    di = cfg.d_inner(D)
    nh = cfg.n_heads(D)
    ds = cfg.d_state
    ph = cfg.head_dim
    cl = min(cfg.chunk, S)
    if S % cl:
        raise ValueError(f"mamba2_block: S={S} is not a multiple of chunk {cl}")
    nc = S // cl

    z, xbc, dt = _ssm_split(cfg, D, x @ p["in_proj"])

    # causal depthwise conv over (x, B, C), kernel 4
    kw = p["conv"].shape[0]
    xbc_pad = F.pad(xbc, (0, 0, kw - 1, 0))
    conv = sum(
        xbc_pad[:, i : i + S, :] * p["conv"][i][None, None, :] for i in range(kw)
    )
    xbc = F.silu(conv + p["conv_b"][None, None, :])
    xs, Bc, Cc = torch.split(xbc, [di, ds, ds], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                           # (B,S,nh)
    A = -torch.exp(p["A_log"].float())                                   # (nh,)
    dA = dt * A[None, None, :]                                           # (B,S,nh) <= 0

    xh = xs.reshape(B, nc, cl, nh, ph)
    Bh = Bc.reshape(B, nc, cl, ds)
    Ch = Cc.reshape(B, nc, cl, ds)
    dAh = dA.reshape(B, nc, cl, nh)
    dth = dt.reshape(B, nc, cl, nh)

    seg = torch.cumsum(dAh, dim=2)                                       # (B,nc,cl,nh)
    # intra-chunk (quadratic within chunk, causal decay):
    # L[i,j] = exp(rel_ij), rel_ij = sum_{j<k<=i} dA_k for i >= j.  The
    # reference takes rel as seg_i - seg_j, which cancels: seg reaches
    # -(chunk * |dt * A|) (thousands at random init, chunk 256), where a
    # float32 ulp is ~2e-4.  Summing each segment directly (a cumsum of the
    # strictly-lower-masked dA) keeps rel exact to its own magnitude.
    ones = torch.ones((cl, cl), dtype=torch.bool, device=x.device)
    strict, causal = torch.tril(ones, diagonal=-1), torch.tril(ones)
    rel = dAh[:, :, :, None, :].expand(B, nc, cl, cl, nh)
    rel = torch.cumsum(rel.masked_fill(~strict[None, None, :, :, None], 0.0),
                       dim=2)                                            # (B,nc,i,j,nh)
    # mask BEFORE exp, as the reference does
    rel = rel.masked_fill(~causal[None, None, :, :, None], NEG_INF)
    decay = torch.exp(rel)
    sBC = _dot32("bnis,bnjs->bnij", Ch, Bh)                              # (B,nc,i,j)
    gate = sBC[..., None] * decay * dth[:, :, None, :, :]                # (B,nc,i,j,nh)
    y_intra = _dot32("bnijh,bnjhp->bnihp", gate.to(xh.dtype), xh)

    # chunk end-states: h_c = sum_j exp(seg_end - seg_j) * dt_j * B_j x_j^T
    # (the decay to the chunk's end is the last row of ``decay``)
    end = seg[:, :, -1:, :]                                              # (B,nc,1,nh)
    w_end = decay[:, :, -1] * dth                                        # (B,nc,cl,nh)
    hc = torch.einsum("bnjs,bnjh,bnjhp->bnhps", Bh.float(),
                      w_end.to(xh.dtype).float(), xh.float())            # (B,nc,nh,ph,ds)

    # inter-chunk recurrence over chunks
    chunk_decay = torch.exp(end[:, :, 0, :])                             # (B,nc,nh)
    h = torch.zeros((B, nh, ph, ds), dtype=torch.float32, device=x.device)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, n, :, None, None] + hc[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                                # (B,nc,nh,ph,ds)

    # inter-chunk output: y_j += C_j · (decay-from-chunk-start_j * h_prev)
    w_start = torch.exp(seg)                                             # (B,nc,cl,nh)
    y_inter = torch.einsum("bnis,bnhps,bnih->bnihp", Ch.float(),
                           h_prevs.to(Ch.dtype).float(),
                           w_start.to(Ch.dtype).float())

    d_skip = p["D_skip"].to(x.dtype)[None, None, None, :, None]
    y = (y_intra + y_inter).to(x.dtype) + xh * d_skip
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    return y @ p["out_proj"], h


def mamba2_decode_block(spec: ModelSpec, x, p, state):
    """Single-token SSD decode. state: dict(ssm (B,nh,ph,ds), conv (B,kw-1,di+2ds))
    -> (out (B,1,D), the new state dict)."""
    cfg: SSMCfg = spec.ssm
    B, S, D = x.shape  # S == 1
    di = cfg.d_inner(D)
    nh = cfg.n_heads(D)
    ds = cfg.d_state
    ph = cfg.head_dim

    z, xbc, dt = _ssm_split(cfg, D, x @ p["in_proj"])
    hist = torch.cat([state["conv"], xbc], dim=1)                        # (B,kw,·)
    conv = torch.einsum("bkc,kc->bc", hist, p["conv"])[:, None, :]
    xbc_t = F.silu(conv + p["conv_b"][None, None, :])
    new_conv = hist[:, 1:, :]
    xs, Bc, Cc = torch.split(xbc_t, [di, ds, ds], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]                     # (B,nh)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A[None, :])                                      # (B,nh)

    xh = xs.reshape(B, nh, ph)
    Bv = Bc[:, 0, :]                                                     # (B,ds)
    Cv = Cc[:, 0, :]
    upd = dt[:, :, None, None] * _dot32("bhp,bs->bhps", xh, Bv)
    ssm = state["ssm"] * dA[:, :, None, None] + upd
    y = _dot32("bhps,bs->bhp", ssm, Cv).to(x.dtype)
    y = y + xh * p["D_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(B, 1, di)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    return y @ p["out_proj"], {"ssm": ssm, "conv": new_conv}
