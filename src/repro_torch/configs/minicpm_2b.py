"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, WSD schedule.

40L d_model=2304 36H (GQA kv=36 == MHA) d_ff=5760 vocab=122753.
long_500k skipped: pure full attention (500k KV cache ~1.8 TB; see DESIGN.md §5).
"""
from repro_torch.models.spec import ModelSpec

SPEC = ModelSpec(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_q=36, n_kv=36, d_ff=5760, vocab=122753,
    tie_embeddings=True, lr_schedule="wsd", sharding_policy="tp",
    skip_shapes=("long_500k",),
    source="arXiv:2404.06395; hf",
)

SMOKE = ModelSpec(
    name="minicpm-2b-smoke", family="dense",
    n_layers=2, d_model=128, n_q=4, n_kv=4, d_ff=320, vocab=512,
    tie_embeddings=True, lr_schedule="wsd",
)
