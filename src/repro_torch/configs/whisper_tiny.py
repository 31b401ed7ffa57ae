"""Whisper-tiny [arXiv:2212.04356; unverified] — enc-dec, conv frontend STUB.

4L enc + 4L dec, d_model=384 6H (MHA) d_ff=1536 vocab=51865, LayerNorm, GELU,
sinusoidal positions (no RoPE).  The conv audio frontend is a stub:
input_specs() provides precomputed frame embeddings (B, S, 384).
long_500k skipped (pure full attention).  Decode shapes run (it has a decoder).
"""
from repro_torch.models.spec import ModelSpec

SPEC = ModelSpec(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4, d_model=384, n_q=6, n_kv=6, d_ff=1536,
    vocab=51865, qkv_bias=True, norm="layernorm", act="gelu", rope_theta=0.0,
    frontend="audio", frontend_dim=384,
    tie_embeddings=True, sharding_policy="tp",
    skip_shapes=("long_500k",),
    source="arXiv:2212.04356 (unverified)",
)

SMOKE = ModelSpec(
    name="whisper-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_q=2, n_kv=2, d_ff=128,
    vocab=512, qkv_bias=True, norm="layernorm", act="gelu", rope_theta=0.0,
    frontend="audio", frontend_dim=64, tie_embeddings=True,
)
