"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family; hf] — dense with QKV bias.

40L d_model=2560 20H (GQA kv=20 == MHA) d_ff=6912 vocab=151936.
long_500k skipped (pure full attention).
Note: 20 heads pad to 32 for the model-axis=16 sharding (DESIGN.md §5) — the
padding waste shows up in the roofline useful/total ratio and is a §Perf target.
"""
from repro_torch.models.spec import ModelSpec

SPEC = ModelSpec(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_q=20, n_kv=20, d_ff=6912, vocab=151936,
    qkv_bias=True, tie_embeddings=False, sharding_policy="tp",
    skip_shapes=("long_500k",),
    source="hf:Qwen/Qwen1.5-4B",
)

SMOKE = ModelSpec(
    name="qwen1.5-smoke", family="dense",
    n_layers=2, d_model=128, n_q=4, n_kv=4, d_ff=320, vocab=512,
    qkv_bias=True, tie_embeddings=False,
)
