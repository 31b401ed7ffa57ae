"""H2O-Danube-1.8B [arXiv:2401.16818; hf] — llama+mistral mix with SWA.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
Runs long_500k: SWA decode uses a rolling window-sized KV cache (sub-quadratic).
"""
from repro_torch.models.spec import ModelSpec

SPEC = ModelSpec(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_q=32, n_kv=8, d_ff=6912, vocab=32000,
    swa_window=4096, tie_embeddings=False, sharding_policy="tp",
    source="arXiv:2401.16818; hf",
)

SMOKE = ModelSpec(
    name="h2o-danube-smoke", family="dense",
    n_layers=2, d_model=128, n_q=4, n_kv=2, d_ff=320, vocab=512,
    swa_window=64, tie_embeddings=False,
)
