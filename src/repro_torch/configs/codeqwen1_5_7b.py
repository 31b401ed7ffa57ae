"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B; hf] — qwen1.5 arch.

32L d_model=4096 32H (GQA kv=32 == MHA) d_ff=13440 vocab=92416, QKV bias.
long_500k skipped (pure full attention).
"""
from repro_torch.models.spec import ModelSpec

SPEC = ModelSpec(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_q=32, n_kv=32, d_ff=13440, vocab=92416,
    qkv_bias=True, tie_embeddings=False, sharding_policy="tp",
    skip_shapes=("long_500k",),
    source="hf:Qwen/CodeQwen1.5-7B",
)

SMOKE = ModelSpec(
    name="codeqwen-smoke", family="dense",
    n_layers=2, d_model=128, n_q=4, n_kv=4, d_ff=352, vocab=512,
    qkv_bias=True, tie_embeddings=False,
)
