"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP + gemma, vision STUB.

18L d_model=2048 8H (GQA kv=1, MQA) head_dim=256 d_ff=16384 vocab=257216,
GeGLU, prefix-LM attention over 256 image tokens.  The SigLIP frontend is a
stub: input_specs() provides precomputed patch embeddings (B, 256, 1152).
long_500k skipped (pure full attention).
"""
from repro_torch.models.spec import ModelSpec

SPEC = ModelSpec(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_q=8, n_kv=1, d_ff=16384, vocab=257216,
    head_dim=256, act="geglu", frontend="vision", frontend_dim=1152,
    n_prefix_tokens=256, tie_embeddings=True, sharding_policy="tp",
    skip_shapes=("long_500k",),
    source="arXiv:2407.07726; hf",
)

SMOKE = ModelSpec(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=128, n_q=4, n_kv=1, d_ff=256, vocab=512,
    head_dim=32, act="geglu", frontend="vision", frontend_dim=48,
    n_prefix_tokens=16, tie_embeddings=True,
)
