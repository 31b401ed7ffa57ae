"""Model specification & logical sharding rules for the assigned architectures.

Every architecture (dense / MoE / SSM / hybrid / enc-dec / VLM) is described by a
single :class:`ModelSpec`.  The decoder is built as a scan over "superblocks": a
superblock is ``period`` consecutive layers with statically-known types, so
heterogeneous stacks (e.g. Jamba's 1:7 attention:mamba interleave with MoE every
other layer) compile to a single small HLO body scanned ``n_layers/period`` times
in the reference (the port's decoder loops over the superblocks).

Sharding is expressed with *logical axes*; :func:`logical_to_pspec` maps them onto
the physical mesh axes ("pod", "data", "model") according to the spec's
``sharding_policy``:

  tp        params sharded over "model" only (heads / ff / vocab / experts);
            replicated over pod+data.  For models whose (params + Adam state)
            fit 16 GB/chip when divided by 16.
  fsdp      tp + the d_model dim of every weight matrix sharded over "data".
  fsdp_pod  tp + d_model sharded over ("pod","data")  (400B-class models).

A copy of ``repro.models.spec`` (the port imports nothing of the reference;
pure data, no device).  :func:`logical_to_pspec` returns the tuple of mesh
axes that ``tuple(PartitionSpec(...))`` gives in the reference.

Head counts / vocab are padded to the next multiple that the model axis divides;
pad rows/cols are zero-initialised and masked out of the loss, so the math is
exact (standard Megatron/MaxText practice).  The *published* numbers are kept in
the spec; ``padded_*`` properties expose the shardable values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

MODEL_AXIS_SIZE = 16  # production mesh model-axis size; padding targets this


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    every: int = 1          # a MoE layer every `every` layers (others dense MLP)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256        # SSD chunk length (state-space duality blocking)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_q: int                         # query heads (0 for attn-free)
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_q
    qkv_bias: bool = False
    swa_window: Optional[int] = None  # sliding-window attention width
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (swiglu) | gelu (plain mlp)
    tie_embeddings: bool = True
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid: within each `period`, which slots are attention (others are mamba)
    period: int = 1
    attn_slots: Tuple[int, ...] = (0,)   # slots in [0, period) that use attention
    # enc-dec (whisper): encoder layer count; decoder = n_layers
    enc_layers: int = 0
    # frontend stub: none | audio | vision
    frontend: str = "none"
    n_prefix_tokens: int = 0         # VLM prefix (bidirectional attention region)
    frontend_dim: int = 0            # raw embedding dim provided by the stub
    sharding_policy: str = "tp"      # tp | fsdp | fsdp_pod
    # which sequence-length shapes are runnable (see DESIGN.md §Arch-applicability)
    skip_shapes: Tuple[str, ...] = ()
    lr_schedule: str = "cosine"      # cosine | wsd
    source: str = ""

    # ---- derived (padded for model-axis sharding) -------------------------

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_q if self.n_q else 0

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, 128 * MODEL_AXIS_SIZE)

    @property
    def padded_n_q(self) -> int:
        return pad_to(self.n_q, MODEL_AXIS_SIZE) if self.n_q else 0

    @property
    def padded_n_kv(self) -> int:
        if not self.n_kv:
            return 0
        if self.n_kv == self.n_q:        # MHA: pad together
            return self.padded_n_q
        # GQA: smallest kv-head count >= published that divides the padded
        # q-head count (llama4: 40q/8kv pads to 48q -> group 6 instead of 5;
        # padded q heads are zero-init and dead, so the math of the published
        # heads is exact — only the head->group mapping shifts, documented).
        nq = self.padded_n_q
        for nkv in range(self.n_kv, nq + 1):
            if nq % nkv == 0:
                return nkv
        return nq

    @property
    def q_group(self) -> int:
        return self.padded_n_q // self.padded_n_kv if self.n_kv else 0

    @property
    def kv_shardable(self) -> bool:
        return bool(self.n_kv) and self.padded_n_kv % MODEL_AXIS_SIZE == 0

    @property
    def attn_every_layer(self) -> bool:
        return self.family in ("dense", "moe", "encdec", "vlm")

    def is_attn_slot(self, slot: int) -> bool:
        if self.family in ("dense", "moe", "encdec", "vlm"):
            return True
        if self.family == "ssm":
            return False
        return slot in self.attn_slots

    def is_moe_slot(self, slot: int, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return (layer_idx % self.moe.every) == (self.moe.every - 1)

    @property
    def n_superblocks(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers, self.period)
        return self.n_layers // self.period

    # ---- parameter counting (for roofline MODEL_FLOPS) --------------------

    def param_count(self, active_only: bool = False) -> int:
        """Published-config parameter count (unpadded), optionally MoE-active."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D
        enc = self.enc_layers
        for li in range(self.n_layers + enc):
            slot = li % self.period if li < self.n_layers else 0
            is_attn = self.is_attn_slot(slot) if li < self.n_layers else True
            if self.family == "ssm":
                is_attn = False
            if is_attn and self.n_q:
                total += D * self.n_q * hd + 2 * D * self.n_kv * hd + self.n_q * hd * D
                if li >= self.n_layers:  # encoder layer; decoder cross-attn added below
                    pass
            if self.family == "encdec" and li < self.n_layers:
                # decoder cross-attention
                total += D * self.n_q * hd + 2 * D * self.n_kv * hd + self.n_q * hd * D
            if not is_attn and self.ssm is not None:
                di = self.ssm.d_inner(D)
                nh = self.ssm.n_heads(D)
                # in_proj (x, z, B, C, dt) + out_proj + conv
                total += D * (2 * di + 2 * self.ssm.d_state + nh) + di * D + 4 * di
            # FFN / MoE
            if li < self.n_layers and self.moe is not None and self.is_moe_slot(slot, li):
                n_ff_mats = 3 if self.act == "silu" else 2
                e = self.moe.top_k if active_only else self.moe.n_experts
                total += e * n_ff_mats * D * F + D * self.moe.n_experts  # + router
            elif F:
                n_ff_mats = 3 if self.act == "silu" else 2
                total += n_ff_mats * D * F
        return total


# ---------------------------------------------------------------------------
# Logical -> mesh axis mapping
# ---------------------------------------------------------------------------

#: logical axis names used in params trees (see models/params.py)
LOGICAL_AXES = (
    "layers",      # stacked superblock dim - never sharded
    "embed",       # d_model dim of weight matrices
    "embed_act",   # d_model dim of embedding table (activations side)
    "q_heads",     # padded query-head dim (sharded over model)
    "kv_heads",    # kv-head dim (replicated when < model axis)
    "head_dim",
    "ff",          # d_ff dim
    "vocab",       # padded vocab dim
    "experts",     # expert dim (NOT sharded in baseline "expert-TP"; see DESIGN)
    "ssm_heads",   # mamba heads
    "ssm_state",
    "conv",
    "batch", "seq", "frames",
)


def rules_for(policy: str, kv_shardable: bool = False) -> dict:
    """logical axis -> mesh axis (or None) for a sharding policy."""
    base = {
        "layers": None,
        "embed": None,
        "embed_act": None,
        "q_heads": "model",
        # kv heads shard over model only when the padded count divides the axis
        # (MHA / large-GQA); otherwise replicated (q-grouping handles the math).
        "kv_heads": "model" if kv_shardable else None,
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": None,           # baseline expert-TP: shard ff dim instead
        "ssm_heads": "model",
        "ssm_state": None,
        "conv": None,
        "batch": ("pod", "data"),
        "seq": None,
        "frames": None,
    }
    if policy == "fsdp":
        base["embed"] = "data"
    elif policy == "fsdp_pod":
        base["embed"] = ("pod", "data")
    elif policy != "tp":
        raise ValueError(policy)
    return base


def logical_to_pspec(logical: Tuple[Optional[str], ...], policy: str,
                     mesh_axis_names: Tuple[str, ...], kv_shardable: bool = False):
    """Map a tuple of logical axis names to a partition spec -- a tuple with
    one entry per dim: a mesh axis, a tuple of mesh axes, or None --
    dropping mesh axes that don't exist on the current mesh (e.g. "pod" on
    the single-pod mesh)."""
    rules = rules_for(policy, kv_shardable)
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
            continue
        tgt = rules[ax]
        if tgt is None:
            out.append(None)
        elif isinstance(tgt, tuple):
            kept = tuple(t for t in tgt if t in mesh_axis_names)
            # PartitionSpec keeps a one-axis tuple as the bare axis name
            out.append(kept[0] if len(kept) == 1 else kept or None)
        else:
            out.append(tgt if tgt in mesh_axis_names else None)
    return tuple(out)
