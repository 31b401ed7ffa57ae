"""The port's LM serving path (``repro_torch.models.steps`` prefill / decode,
``models/decoder.py``, ``launch/serve.py``) against the reference's, for
all ten SMOKE archs (oracle ``tests/test_smoke_archs.py:77``).

The reference's parameters (``init_params(PRNGKey(0), dtype=float32)``)
cross to the port through ``params_from_numpy``; the seeded numpy prompts,
frames and patches feed both.  One jitted reference function per arch runs
the prefill and three decode steps from zero caches, so each arch costs one
JAX compile.  Tolerances are relative to the largest magnitude of the
reference's tensor: 1e-4 in float32 for logits, hidden states and caches;
3e-2 for the bfloat16 case, where torch rounds after every op and XLA's CPU
backend computes elementwise chains in float32 between fusion boundaries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALIASES  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import decoder as ref_dec  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import make_prefill_step as ref_make_prefill  # noqa: E402
from repro.models.steps import cache_specs as ref_cache_specs  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decoder as dec  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import params_from_numpy, zeros_caches  # noqa: E402

ARCHS = list(ALIASES)
B, S, KV_CHUNK, LC, STEPS = 2, 64, 32, 32, 3
TOL = 1e-4
BF16_TOL = 3e-2


def rel_err(got, want):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def make_inputs(spec, seed):
    """Seeded numpy prompts (+ frames / patches), shaped as the smoke tests
    shape them, and the first decode tokens."""
    r = np.random.default_rng(seed)
    tokens = r.integers(0, spec.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": tokens}
    if spec.family == "encdec":
        batch["frames"] = r.normal(size=(B, S, spec.frontend_dim)).astype(np.float32)
    if spec.family == "vlm":
        npre = spec.n_prefix_tokens
        batch = {
            "patches": r.normal(size=(B, npre, spec.frontend_dim)).astype(np.float32),
            "tokens": tokens[:, : S - npre],
        }
    tok0 = r.integers(0, spec.vocab, (B, 1)).astype(np.int32)
    return batch, tok0


def reference_run(spec, params, batch, tok0, dtype):
    """One jitted reference function: prefill, then STEPS greedy decode steps
    from zero caches -> (prefill logits, prefill caches, per step (input
    token, hidden, logits, caches))."""
    prefill = ref_make_prefill(spec, kv_chunk=KV_CHUNK)
    caches0 = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                           ref_cache_specs(spec, B, LC, dtype=dtype))
    bias = ref_dec.vocab_mask_bias(spec)

    def run(params, batch, caches, tok):
        logits, pcaches = prefill(params, batch)

        def step(carry, i):
            caches, tok = carry
            x = ref_dec.embed_tokens(spec, params, tok, jnp.full((1,), i))
            h, caches = ref_dec.decoder_decode(spec, params, x, caches, i)
            lg = ref_dec.lm_logits(spec, params, h).astype(jnp.float32) + bias
            nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            return (caches, nxt), (tok, h, lg, caches)

        _, steps = jax.lax.scan(step, (caches, tok), jnp.arange(STEPS))
        return logits, pcaches, steps

    out = jax.jit(run)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       caches0, jnp.asarray(tok0))
    logits, pcaches, steps = jax.tree.map(np.asarray, out)
    return logits, pcaches, [jax.tree.map(lambda a: a[i], steps)
                             for i in range(STEPS)]


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def compare_arch(arch, dtype, tol):
    spec = get_smoke(arch)
    rspec = ref_get_smoke(arch)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rparams = ref_init_params(rspec, jax.random.PRNGKey(0), dtype=jdt)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    batch, tok0 = make_inputs(spec, 1)
    want_logits, want_pc, want_steps = reference_run(rspec, rparams, batch, tok0, jdt)

    logits, pcaches = make_prefill_step(spec, kv_chunk=KV_CHUNK)(params, to_torch(batch))
    errs = {"prefill_logits": rel_err(logits, want_logits)}
    for slot, c in want_pc.items():
        for name, want in c.items():
            errs[f"prefill_{slot}_{name}"] = rel_err(pcaches[slot][name], want)

    caches = zeros_caches(spec, B, LC, device="cpu", dtype=dtype)
    bias = dec.vocab_mask_bias(spec, device="cpu")
    decode = make_decode_step(spec)
    flips = 0
    for i, (tok, want_h, want_lg, want_c) in enumerate(want_steps):
        tok = torch.from_numpy(tok.copy())
        x = dec.embed_tokens(spec, params, tok, torch.full((1,), i))
        h, new_caches = dec.decoder_decode(
            spec, params, x, {s: {n: t.clone() for n, t in c.items()}
                              for s, c in caches.items()}, i)
        lg = dec.lm_logits(spec, params, h).float() + bias
        errs[f"step{i}_hidden"] = rel_err(h, want_h)
        errs[f"step{i}_logits"] = rel_err(lg, want_lg)
        for slot, c in want_c.items():
            for name, want in c.items():
                errs[f"step{i}_{slot}_{name}"] = rel_err(new_caches[slot][name], want)
        # the decode step itself: its token where the reference's top-2
        # margin exceeds the tolerance (a greedy argmax flips on a near tie)
        next_tok, caches = decode(params, caches, tok, i)
        top2 = np.sort(want_lg[:, 0], axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > tol * np.abs(want_lg).max()
        ref_tok = want_lg[:, 0].argmax(-1)
        flips += int((next_tok[:, 0].numpy() != ref_tok)[sure].sum())
        for slot, c in caches.items():
            for name, t in c.items():
                assert torch.equal(t, new_caches[slot][name]), (arch, i, slot, name)
    bad = {k: v for k, v in errs.items() if not v <= tol}
    assert not bad, f"{arch}: {bad}"
    assert flips == 0, f"{arch}: {flips} greedy tokens differ"
    return errs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_f32(arch):
    compare_arch(arch, torch.float32, TOL)


def test_prefill_and_decode_match_reference_bf16():
    compare_arch("qwen1.5-4b", torch.bfloat16, BF16_TOL)


def test_whisper_decode_cross_attention_is_zero_in_both():
    """The reference's serve CLI decodes from zero caches built from
    ``cache_specs`` (``src/repro/launch/serve.py:65-66``), whose cross K/V
    are 1500 zero rows (``src/repro/models/steps.py:296-299``): every decode
    step's cross-attention output is exactly 0 in both packages, so
    decoding ignores the encoder.  The port keeps the behaviour."""
    arch = "whisper-tiny"
    spec, rspec = get_smoke(arch), ref_get_smoke(arch)
    rparams = ref_init_params(rspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    rc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      ref_cache_specs(rspec, B, LC, dtype=jnp.float32))
    caches = zeros_caches(spec, B, LC, device="cpu", dtype=torch.float32)
    assert caches["slot0"]["cross_k"].shape[2] == 1500
    h = np.random.default_rng(3).normal(size=(B, 1, spec.d_model)).astype(np.float32)
    for i in range(spec.n_superblocks):
        rp = jax.tree.map(lambda a: a[i], rparams["sb"]["slot0"]["cross"])
        want = ref_layers.cross_attention_block(
            rspec, jnp.asarray(h), rp,
            (rc["slot0"]["cross_k"][i], rc["slot0"]["cross_v"][i]))
        got = layers.cross_attention_block(
            spec, torch.from_numpy(h),
            {k: v[i] for k, v in params["sb"]["slot0"]["cross"].items()},
            (caches["slot0"]["cross_k"][i], caches["slot0"]["cross_v"][i]))
        assert float(np.abs(np.asarray(want)).max()) == 0.0
        assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-780m"])
def test_serve_cli_smoke_on_cpu(arch, capsys):
    rc = serve.main(["--smoke", "--arch", arch, "--device", "cpu",
                     "--batch", "2", "--prompt-len", "32", "--gen", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    assert lines[0].startswith(f"[serve] arch={get_smoke(arch).name}")
    assert any(ln.startswith("[serve] prefill 2x32:") for ln in lines)
    assert any("tokens/s" in ln for ln in lines)
    assert lines[-1] == "[serve] ok"
