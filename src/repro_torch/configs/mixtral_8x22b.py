"""Mixtral-8x22B [arXiv:2401.04088; hf] — 8 experts top-2, SWA.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2 per layer,
sliding-window attention (window 4096).
Runs long_500k via the SWA rolling cache.  fsdp: 141B params + Adam.
"""
from repro_torch.models.spec import ModelSpec, MoECfg

SPEC = ModelSpec(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_q=48, n_kv=8, d_ff=16384, vocab=32768,
    head_dim=128, moe=MoECfg(n_experts=8, top_k=2, every=1),
    swa_window=4096, tie_embeddings=False, sharding_policy="fsdp",
    source="arXiv:2401.04088; hf",
)

SMOKE = ModelSpec(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=128, n_q=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, moe=MoECfg(n_experts=4, top_k=2, every=1),
    swa_window=64, tie_embeddings=False,
)
