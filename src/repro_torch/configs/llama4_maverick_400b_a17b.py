"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-*; unverified] — MoE.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048,
MoE 128 experts top-1.  MoE layers interleave with dense layers (every 2nd
layer MoE -> ~400B total params as the checkpoint name states; the assignment
line gives per-layer numbers only, interleave documented here).
fsdp_pod sharding: params+Adam state (~400B * 10B) need all 512 chips.
long_500k skipped (full attention at this scale).
"""
from repro_torch.models.spec import ModelSpec, MoECfg

SPEC = ModelSpec(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_q=40, n_kv=8, d_ff=8192, vocab=202048,
    head_dim=128, moe=MoECfg(n_experts=128, top_k=1, every=2),
    period=2, tie_embeddings=False, sharding_policy="fsdp_pod",
    skip_shapes=("long_500k",),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
)

SMOKE = ModelSpec(
    name="llama4-smoke", family="moe",
    n_layers=2, d_model=128, n_q=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, moe=MoECfg(n_experts=4, top_k=1, every=2), period=2,
    tie_embeddings=False,
)
