"""Mamba2-780M [arXiv:2405.21060; unverified] — SSD (state-space duality).

48L d_model=1536, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*1536 = 3072, 48 SSD heads of dim 64.  Runs long_500k (O(1) state).
"""
from repro_torch.models.spec import ModelSpec, SSMCfg

SPEC = ModelSpec(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_q=0, n_kv=0, d_ff=0, vocab=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, chunk=256),
    attn_slots=(), tie_embeddings=True, sharding_policy="tp",
    source="arXiv:2405.21060 (unverified)",
)

SMOKE = ModelSpec(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=128, n_q=0, n_kv=0, d_ff=0, vocab=512,
    ssm=SSMCfg(d_state=16, head_dim=32, expand=2, chunk=32),
    attn_slots=(), tie_embeddings=True,
)
