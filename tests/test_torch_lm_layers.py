"""The port's LM layers (``repro_torch.models.layers``, forward) against the
reference's ``repro.models.layers`` on the same seeded float32 inputs, and
the port's decode blocks against its own prefill blocks.

Block weights are seeded numpy draws (every leaf, the zero-initialised
biases and norms included, so each term is exercised) of the shapes the
reference's ``param_defs`` gives the SMOKE configs.  Tolerances: 2e-5 for
``flash_attention`` (the reference's own vjp-vs-scan gate,
``tests/test_flash_vjp.py:43``), 1e-5 relative to the largest magnitude for
the other float32 blocks, 2e-2 for the one bfloat16 case.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.params import param_defs as ref_param_defs  # noqa: E402
from repro.models.spec import MoECfg as RefMoECfg  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.spec import MoECfg  # noqa: E402

TOL = 1e-5
FLASH_TOL = 2e-5
BF16_TOL = 2e-2

#: (B, Sq, Skv, Hq, Hkv, hd, causal, window, prefix, kv_chunk): the CASES of
#: tests/test_flash_vjp.py:25-33
CASES = [
    (2, 16, 16, 4, 4, 8, True, None, 0, 8),
    (2, 16, 16, 4, 2, 8, True, None, 0, 8),     # GQA
    (1, 32, 32, 4, 1, 8, True, 8, 0, 16),       # MQA + SWA
    (2, 16, 16, 4, 4, 8, True, None, 6, 8),     # prefix-LM
    (1, 12, 20, 2, 2, 8, False, None, 0, 8),    # cross-attn, ragged chunk
    (1, 16, 16, 4, 4, 8, True, None, 0, 16),    # single chunk
    (2, 8, 24, 4, 2, 16, True, None, 0, 10),    # Skv % chunk != 0
]


def rel_err(got, want):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def both(a, dtype=np.float32):
    """A numpy array as (jax array, torch tensor)."""
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def specs(arch, **changes):
    return (dataclasses.replace(ref_get_smoke(arch), **changes),
            dataclasses.replace(get_smoke(arch), **changes))


def block(rspec, key, slot=0, seed=0, scale=0.1):
    """Seeded weights of superblock 0's ``key`` block -> (jax tree, torch tree)."""
    r = np.random.default_rng(seed)
    defs = ref_param_defs(rspec)["sb"][f"slot{slot}"][key]
    arrs = {k: (r.normal(size=d.shape[1:]) * scale).astype(np.float32)
            for k, d in defs.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# norms, rope, MLP
# ---------------------------------------------------------------------------


def test_norms_match_reference():
    xj, xt = both(normal(0, 2, 5, 16) * 3 + 1)
    wj, wt = both(normal(1, 16))
    bj, bt = both(normal(2, 16))
    assert rel_err(L.rms_norm(xt, wt), RL.rms_norm(xj, wj)) <= TOL
    assert rel_err(L.layer_norm(xt, wt, bt), RL.layer_norm(xj, wj, bj)) <= TOL
    for norm in ("rmsnorm", "layernorm"):
        rspec, spec = specs("qwen1.5-4b", d_model=16, norm=norm)
        p = {"w": wt, "b": bt}
        rp = {"w": wj, "b": bj}
        assert rel_err(L.apply_norm(spec, xt, p), RL.apply_norm(rspec, xj, rp)) <= TOL


def test_rope_matches_reference():
    """Tables at an absolute 2 * max_pos * 2^-24: a frequency from ``exp``
    may differ by an ulp (< 2^-24, frequencies are <= 1) between the two
    libraries, which moves the angle by up to pos * 2^-24, and the angle's
    own rounding adds as much again."""
    pos = np.array([0, 3, 7, 100, 4095], np.int32)
    pos2 = np.stack([pos, pos + 9])
    xj, xt = both(normal(0, 2, 5, 3, 16))
    for p_, theta in ((pos, 10_000.0), (pos2, 500.0)):
        atol = 2 * int(p_.max()) * 2.0**-24
        cj, sj = RL.rope_tables(jnp.asarray(p_), 16, theta)
        ct, st = L.rope_tables(torch.from_numpy(p_), 16, theta)
        np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=atol)
        np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=atol)
        # rotation on the same tables: (S, half) and per-batch (B, S, half)
        got = L.apply_rope(xt, torch.from_numpy(np.asarray(cj)),
                           torch.from_numpy(np.asarray(sj)))
        assert rel_err(got, RL.apply_rope(xj, cj, sj)) <= TOL


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_block_matches_reference(act):
    rspec, spec = specs("qwen1.5-4b", act=act)
    rp, p = block(rspec, "mlp")
    xj, xt = both(normal(0, 2, 7, spec.d_model))
    assert rel_err(L.mlp_block(spec, xt, p), RL.mlp_block(rspec, xj, rp)) <= TOL


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def qkv(seed, B, Sq, Skv, Hq, Hkv, hd):
    r = np.random.default_rng(seed)
    return [both(r.normal(size=s) * 0.5) for s in
            ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd))]


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_reference(case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, prefix, chunk = case
    (qj, qt), (kj, kt), (vj, vt) = qkv(0, B, Sq, Skv, Hq, Hkv, hd)
    kw = dict(causal=causal, window=window, prefix_len=prefix, kv_chunk=chunk)
    want = np.asarray(RL.flash_attention(qj, kj, vj, impl="vjp", **kw))
    for impl in ("vjp", "scan"):
        got = L.flash_attention(qt, kt, vt, impl=impl, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=FLASH_TOL, atol=FLASH_TOL,
                                   err_msg=f"{impl} {case}")


def test_flash_attention_kv_len_mask_and_offsets_match_reference():
    """The scan impl's ragged-cache mask and position offsets."""
    (qj, qt), (kj, kt), (vj, vt) = qkv(1, 2, 6, 20, 4, 2, 8)
    mask = np.ones((2, 20), bool)
    mask[0, 13:] = False
    mask[1, 5:] = False
    kw = dict(causal=True, window=12, q_offset=14, kv_offset=0, kv_chunk=8)
    want = RL.flash_attention(qj, kj, vj, impl="scan",
                              kv_len_mask=jnp.asarray(mask), **kw)
    got = L.flash_attention(qt, kt, vt, impl="scan",
                            kv_len_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


def test_flash_impl_setting():
    assert L.FLASH_IMPL in ("vjp", "scan")
    old = L.FLASH_IMPL
    try:
        L.set_flash_impl("scan")
        assert L.FLASH_IMPL == "scan"
    finally:
        L.set_flash_impl(old)
    with pytest.raises(ValueError):
        L.flash_attention(*[torch.zeros(1, 2, 1, 4)] * 3, impl="pallas")


@pytest.mark.parametrize("n_valid", [1, 5, 12])
def test_decode_attention_matches_reference(n_valid):
    (qj, qt), (kj, kt), (vj, vt) = qkv(2, 2, 1, 12, 4, 2, 8)
    want = RL.decode_attention(qj, kj, vj, n_valid)
    got = L.decode_attention(qt, kt, vt, n_valid)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("arch,window,Lc,steps", [
    ("qwen1.5-4b", None, 16, 6),        # plain cache
    ("h2o-danube-1.8b", 8, 8, 13),       # rolling SWA buffer across the wrap
])
def test_attention_decode_block_matches_reference(arch, window, Lc, steps):
    rspec, spec = specs(arch, swa_window=window)
    rp, p = block(rspec, "attn")
    B, Hkv, hd = 2, spec.padded_n_kv, spec.hd
    rcache = {"k": jnp.zeros((B, Lc, Hkv, hd)), "v": jnp.zeros((B, Lc, Hkv, hd))}
    cache = {"k": torch.zeros(B, Lc, Hkv, hd), "v": torch.zeros(B, Lc, Hkv, hd)}
    x = normal(3, steps, B, 1, spec.d_model)
    for pos in range(steps):
        want, rcache = RL.attention_decode_block(rspec, jnp.asarray(x[pos]), rp,
                                                 rcache, pos)
        got, cache = L.attention_decode_block(spec, torch.from_numpy(x[pos]), p,
                                              cache, pos)
        assert rel_err(got, want) <= TOL, pos
        assert rel_err(cache["k"], rcache["k"]) <= TOL, pos
        assert rel_err(cache["v"], rcache["v"]) <= TOL, pos


def test_cross_attention_block_matches_reference():
    rspec, spec = specs("whisper-tiny")
    rp, p = block(rspec, "cross")
    B, Se, Hkv, hd = 2, 20, spec.padded_n_kv, spec.hd
    (kj, kt), (vj, vt) = both(normal(4, B, Se, Hkv, hd)), both(normal(5, B, Se, Hkv, hd))
    xj, xt = both(normal(6, B, 3, spec.d_model))
    want = RL.cross_attention_block(rspec, xj, rp, (kj, vj))
    got = L.cross_attention_block(spec, xt, p, (kt, vt))
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("arch,prefix", [("qwen1.5-4b", 0), ("paligemma-3b", 5),
                                         ("h2o-danube-1.8b", 0)])
def test_attention_block_matches_reference(arch, prefix):
    changes = {"swa_window": 6} if arch.startswith("h2o") else {}
    rspec, spec = specs(arch, **changes)
    rp, p = block(rspec, "attn")
    S = 12
    xj, xt = both(normal(7, 2, S, spec.d_model))
    pos = np.arange(S)
    want, (wk, wv) = RL.attention_block(rspec, xj, rp, positions=jnp.asarray(pos),
                                        prefix_len=prefix, kv_chunk=8)
    got, (gk, gv) = L.attention_block(spec, xt, p, positions=torch.from_numpy(pos),
                                      prefix_len=prefix, kv_chunk=8)
    assert rel_err(got, want) <= TOL
    assert rel_err(gk, wk) <= TOL and rel_err(gv, wv) <= TOL


def test_attention_block_bf16_matches_reference():
    rspec, spec = specs("qwen1.5-4b")
    rp, p = block(rspec, "attn")
    rp = {k: v.astype(jnp.bfloat16) for k, v in rp.items()}
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = normal(8, 2, 16, spec.d_model)
    pos = np.arange(16)
    want, _ = RL.attention_block(rspec, jnp.asarray(x, jnp.bfloat16), rp,
                                 positions=jnp.asarray(pos), kv_chunk=8)
    got, _ = L.attention_block(spec, torch.from_numpy(x).to(torch.bfloat16), p,
                               positions=torch.from_numpy(pos), kv_chunk=8)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, np.asarray(want, np.float32)) <= BF16_TOL


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_block_drops_and_matches_reference(act):
    """Capacity factor 0.5 at S = 16, E = 4, K = 2: C = 4 slots an expert
    for 8 routed tokens on average, so tokens are dropped."""
    rspec, spec = specs("mixtral-8x22b", act=act,
                        moe=RefMoECfg(n_experts=4, top_k=2, capacity_factor=0.5))
    spec = dataclasses.replace(spec, moe=MoECfg(n_experts=4, top_k=2,
                                                capacity_factor=0.5))
    rp, p = block(rspec, "moe", scale=0.3)
    xj, xt = both(normal(9, 2, 16, spec.d_model))
    want, waux = RL.moe_block(rspec, xj, rp)
    got, aux = L.moe_block(spec, xt, p)
    assert rel_err(got, want) <= TOL
    assert abs(float(aux) - float(waux)) <= TOL * abs(float(waux))
    # the same tokens with room for all of them: a different output
    roomy = dataclasses.replace(spec, moe=MoECfg(n_experts=4, top_k=2,
                                                 capacity_factor=4.0))
    full, _ = L.moe_block(roomy, xt, p)
    assert not torch.allclose(full, got)


def test_moe_decode_block_matches_reference():
    rspec, spec = specs("llama4-maverick-400b-a17b")   # top-1, MoE on slot 1
    rp, p = block(rspec, "moe", slot=1, scale=0.3)
    xj, xt = both(normal(10, 3, 1, spec.d_model))
    want, _ = RL.moe_decode_block(rspec, xj, rp)
    got, _ = L.moe_decode_block(spec, xt, p)
    assert rel_err(got, want) <= TOL


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def test_mamba2_block_two_chunks_matches_reference():
    rspec, spec = specs("mamba2-780m")                  # chunk 32
    rp, p = block(rspec, "ssm")
    xj, xt = both(normal(11, 2, 64, spec.d_model))
    want, wstate = RL.mamba2_block(rspec, xj, rp)
    got, state = L.mamba2_block(spec, xt, p)
    assert rel_err(got, want) <= TOL
    assert rel_err(state, wstate) <= TOL


def test_mamba2_decode_block_from_zero_state_matches_reference():
    rspec, spec = specs("mamba2-780m")
    rp, p = block(rspec, "ssm")
    cfg = spec.ssm
    di, nh = cfg.d_inner(spec.d_model), cfg.n_heads(spec.d_model)
    B = 2
    rstate = {"ssm": jnp.zeros((B, nh, cfg.head_dim, cfg.d_state)),
              "conv": jnp.zeros((B, 3, di + 2 * cfg.d_state))}
    state = {k: torch.zeros(v.shape) for k, v in rstate.items()}
    x = normal(12, 6, B, 1, spec.d_model)
    for t in range(6):
        want, rstate = RL.mamba2_decode_block(rspec, jnp.asarray(x[t]), rp, rstate)
        got, state = L.mamba2_decode_block(spec, torch.from_numpy(x[t]), p, state)
        assert rel_err(got, want) <= TOL, t
        assert rel_err(state["ssm"], rstate["ssm"]) <= TOL, t
        assert rel_err(state["conv"], rstate["conv"]) <= TOL, t


# ---------------------------------------------------------------------------
# the port alone: decoding token by token reproduces the prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,window", [("qwen1.5-4b", None),
                                         ("h2o-danube-1.8b", 6)])
def test_attention_decode_reproduces_prefill(arch, window):
    _, spec = specs(arch, swa_window=window)
    rspec = ref_get_smoke(arch)
    _, p = block(dataclasses.replace(rspec, swa_window=window), "attn")
    B, S = 2, 20
    x = torch.from_numpy(normal(13, B, S, spec.d_model))
    want, _ = L.attention_block(spec, x, p, positions=torch.arange(S), kv_chunk=8)
    Lc = window or S
    cache = {n: torch.zeros(B, Lc, spec.padded_n_kv, spec.hd) for n in ("k", "v")}
    for t in range(S):
        got, cache = L.attention_decode_block(spec, x[:, t:t + 1], p, cache, t)
        assert rel_err(got, want[:, t:t + 1].numpy()) <= TOL, t


def test_ssd_decode_reproduces_prefill():
    rspec, spec = specs("mamba2-780m")
    _, p = block(rspec, "ssm")
    cfg = spec.ssm
    di, nh = cfg.d_inner(spec.d_model), cfg.n_heads(spec.d_model)
    B, S = 2, 64                                          # two chunks of 32
    x = torch.from_numpy(normal(14, B, S, spec.d_model))
    want, hT = L.mamba2_block(spec, x, p)
    state = {"ssm": torch.zeros(B, nh, cfg.head_dim, cfg.d_state),
             "conv": torch.zeros(B, 3, di + 2 * cfg.d_state)}
    for t in range(S):
        got, state = L.mamba2_decode_block(spec, x[:, t:t + 1], p, state)
        assert rel_err(got, want[:, t:t + 1].numpy()) <= 1e-4, t
    assert rel_err(state["ssm"], hT.numpy()) <= 1e-4


def test_ssd_prefill_keeps_to_its_recurrence_where_the_reference_cancels():
    """A reference fault the port does not copy.  The reference's chunked
    SSD takes each within-chunk decay as exp(seg_i - seg_j) of one cumsum
    ``seg`` (``src/repro/models/layers.py:660-667``, ``:676``); over a chunk
    of 256 at dA ~ -2.1 a step, seg reaches ~-540, whose float32 ulp (6e-5)
    the differences keep, so its prefill strays from its own decode
    recurrence.  The port sums each segment directly and stays within
    float32 rounding of its recurrence."""
    from repro.models.spec import SSMCfg as RefSSMCfg
    from repro_torch.models.spec import SSMCfg

    cfg = dict(d_state=16, head_dim=32, expand=2, chunk=256)
    rspec = dataclasses.replace(ref_get_smoke("mamba2-780m"), ssm=RefSSMCfg(**cfg))
    spec = dataclasses.replace(get_smoke("mamba2-780m"), ssm=SSMCfg(**cfg))
    rp, p = block(rspec, "ssm")
    nh = spec.ssm.n_heads(spec.d_model)
    rp.update(A_log=jnp.zeros(nh), dt_bias=jnp.full(nh, 2.0))   # A = -1
    p.update(A_log=torch.zeros(nh), dt_bias=torch.full((nh,), 2.0))
    B, S = 1, 256
    x = normal(15, B, S, spec.d_model)
    di, ds = spec.ssm.d_inner(spec.d_model), spec.ssm.d_state

    ref_step = jax.jit(lambda xt, st: RL.mamba2_decode_block(rspec, xt, rp, st))
    rstate = {"ssm": jnp.zeros((B, nh, 32, ds)), "conv": jnp.zeros((B, 3, di + 2 * ds))}
    state = {k: torch.zeros(v.shape) for k, v in rstate.items()}
    rsteps, steps = [], []
    for t in range(S):
        o, rstate = ref_step(jnp.asarray(x[:, t:t + 1]), rstate)
        rsteps.append(np.asarray(o))
        o, state = L.mamba2_decode_block(spec, torch.from_numpy(x[:, t:t + 1]), p, state)
        steps.append(o)
    want_r, _ = RL.mamba2_block(rspec, jnp.asarray(x), rp)
    want, _ = L.mamba2_block(spec, torch.from_numpy(x), p)
    ref_gap = rel_err(torch.from_numpy(np.array(want_r)), np.concatenate(rsteps, 1))
    gap = rel_err(want, torch.cat(steps, 1).numpy())
    print(f"prefill vs recurrence: reference {ref_gap:.3e}, port {gap:.3e}")
    assert gap <= TOL
    assert ref_gap > 5 * gap, (ref_gap, gap)
