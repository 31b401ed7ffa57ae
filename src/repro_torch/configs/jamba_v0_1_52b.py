"""Jamba-v0.1-52B [arXiv:2403.19887; hf] — hybrid Mamba+attention, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2 every
2nd layer, attention:mamba 1:7 (one attention layer per 8-layer period, slot 4
as in the released model).  Jamba's mamba layers use d_state=16.
Runs long_500k: mamba state decode + 4 attention layers whose KV caches are
sequence-sharded over ("data","model") (distributed flash-decoding).
"""
from repro_torch.models.spec import ModelSpec, MoECfg, SSMCfg

SPEC = ModelSpec(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_q=32, n_kv=8, d_ff=14336, vocab=65536,
    head_dim=128, moe=MoECfg(n_experts=16, top_k=2, every=2),
    ssm=SSMCfg(d_state=16, head_dim=64, expand=2, chunk=256),
    period=8, attn_slots=(4,), tie_embeddings=False, sharding_policy="fsdp",
    source="arXiv:2403.19887; hf",
)

SMOKE = ModelSpec(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=128, n_q=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, moe=MoECfg(n_experts=4, top_k=2, every=2),
    ssm=SSMCfg(d_state=16, head_dim=32, expand=2, chunk=32),
    period=8, attn_slots=(4,), tie_embeddings=False,
)
