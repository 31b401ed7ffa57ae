"""The port's LM optimizer side against the reference's:
``data/tokens.SyntheticTokens`` (bit-equal), ``optim/schedules.make_schedule``
(cosine and wsd at every step, 1e-6 relative), ``optim/adamw`` (f32 leaves,
moments and the global norm within 1e-6 of each leaf's largest magnitude,
bf16 leaves within one bf16 ulp) and ``optim/compress.compress_grads`` on
nested trees (bit-equal; the GS trainer's flat dicts too).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.tokens import SyntheticTokens as RefTokens  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import compress_grads as ref_compress  # noqa: E402
from repro.optim import make_schedule as ref_make_schedule  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,  # noqa: E402
                               compress_grads, global_norm, make_schedule)
from repro_torch.runtime.checkpoint import tree_flatten  # noqa: E402

TOL = 1e-6


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab,seq,gb,steps,shards", [
    (0, 1000, 32, 8, (0, 5, 6), (1, 2, 4, 8)),
    (3, 122753, 64, 8, (0, 1, 1234), (1, 2)),
    (7, 512, 16, 12, (0, 9999), (1, 3, 4)),
    (11, 40, 8, 2, (3,), (1, 2)),
])
def test_tokens_bit_equal_to_reference(seed, vocab, seq, gb, steps, shards):
    ref = RefTokens(vocab=vocab, seq=seq, global_batch=gb, seed=seed)
    port = SyntheticTokens(vocab=vocab, seq=seq, global_batch=gb, seed=seed)
    for step in steps:
        for n in shards:
            for sh in range(n):
                want = ref.batch(step, shard=sh, n_shards=n)
                got = port.batch(step, shard=sh, n_shards=n, device="cpu")
                for k in ("tokens", "labels"):
                    assert got[k].dtype == torch.int32
                    np.testing.assert_array_equal(got[k].numpy(),
                                                  np.asarray(want[k]))


def test_tokens_properties():
    """``tests/test_data.py:44`` and ``:63`` on the port's stream."""
    ds = SyntheticTokens(vocab=1000, seq=32, global_batch=8, seed=3)
    a = ds.batch(5, device="cpu")
    assert torch.equal(a["tokens"], ds.batch(5, device="cpu")["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    halves = [ds.batch(5, shard=s, n_shards=2, device="cpu")["tokens"]
              for s in range(2)]
    assert torch.equal(torch.cat(halves), a["tokens"])
    assert not torch.equal(a["tokens"], ds.batch(6, device="cpu")["tokens"])
    for step, shards in ((0, 1), (17, 4), (9999, 3)):
        ds = SyntheticTokens(vocab=512, seq=16, global_batch=4 * shards)
        for s in range(shards):
            t = ds.batch(step, shard=s, n_shards=shards, device="cpu")["tokens"]
            assert int(t.min()) >= 0 and int(t.max()) < 512
    with pytest.raises(ValueError):
        ds.batch(0, n_shards=5, device="cpu")


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,total,warmup,decay_frac,min_ratio", [
    ("cosine", 10, 100, 0.1, 0.1),       # warmup longer than the run
    ("cosine", 400, 100, 0.1, 0.1),
    ("cosine", 250, 0, 0.1, 0.2),
    ("wsd", 4, 100, 0.1, 0.1),           # the card's CLI run
    ("wsd", 500, 100, 0.1, 0.1),
    ("wsd", 300, 30, 0.25, 0.0),
])
def test_schedule_matches_reference(kind, total, warmup, decay_frac, min_ratio):
    ref = ref_make_schedule(kind, total, warmup, decay_frac, min_ratio)
    port = make_schedule(kind, total, warmup, decay_frac, min_ratio)
    steps = np.arange(total + 1)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(port(int(s))) for s in steps])
    tensor_steps = port(torch.tensor(steps, dtype=torch.int32))
    assert tensor_steps.dtype == torch.float32
    np.testing.assert_array_equal(tensor_steps.numpy(), got.astype(np.float32))
    assert port(torch.tensor(3, dtype=torch.int32)).shape == ()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)
    # the boundaries: warmup start, its end, the decay's start and the end
    assert got[0] == 0.0 or warmup == 0
    assert got[-1] == pytest.approx(float(want[-1]), rel=TOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def nested_tree(seed, scale):
    """A seeded nested tree with float32 and bfloat16 leaves (numpy; bf16 as
    ml_dtypes arrays)."""
    r = np.random.default_rng(seed)
    f32 = lambda *s: (r.normal(size=s) * scale).astype(np.float32)
    bf16 = lambda *s: (r.normal(size=s) * scale).astype(jnp.bfloat16)
    return {
        "embed": bf16(64, 16),
        "final_norm": {"w": f32(16)},
        "sb": {"slot0": {"attn": {"wq": bf16(3, 16, 24), "wo": f32(3, 24, 16)},
                         "ln": {"w": bf16(3, 16), "b": f32(3, 16)}}},
    }


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def exact_norm(g_np):
    return float(np.sqrt(sum(np.sum(np.asarray(a, np.float64) ** 2)
                             for a in jax.tree.leaves(g_np))))


@pytest.mark.parametrize("grad_clip,grad_scale", [(1.0, 3.0), (1e6, 0.05)],
                         ids=["clip_active", "clip_inactive"])
def test_adamw_matches_reference(grad_clip, grad_scale):
    """With the clip active, the moments scale by grad_clip / |g|: the
    reference sums |g|^2 in an order that rounds it 3.4e-7-5.9e-7 off the
    float64 norm on these trees, the port within 2e-8.  So m is held at
    TOL plus the two norms' relative gap, v (quadratic in the clip) at TOL
    plus twice it, and each package's norm against the float64 one."""
    kw = dict(lr=1e-2, grad_clip=grad_clip)
    ref_cfg, cfg = RefAdamWConfig(**kw), AdamWConfig(**kw)
    p_np = nested_tree(0, 0.5)
    rp = as_jax(p_np)
    rst = ref_adamw_init(rp)
    params = params_from_numpy(p_np, device="cpu")
    st = adamw_init(params)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    for i, lr_scale in enumerate((0.0, 0.5, 1.0)):
        g_np = nested_tree(10 + i, grad_scale)
        rp, rst, rstats = ref_adamw_update(ref_cfg, rp, as_jax(g_np), rst,
                                           jnp.float32(lr_scale))
        grads = params_from_numpy(g_np, device="cpu")
        params, st, stats = adamw_update(
            cfg, params, grads, st, torch.tensor(lr_scale, dtype=torch.float32))
        want_gn, got_gn = float(rstats["grad_norm"]), float(stats["grad_norm"])
        exact = exact_norm(jax.tree.map(lambda a: np.asarray(a, np.float32), g_np))
        assert got_gn == pytest.approx(want_gn, rel=TOL)
        assert got_gn == pytest.approx(exact, rel=1e-7)
        assert want_gn == pytest.approx(exact, rel=TOL)
        assert float(global_norm(grads)) == got_gn
        clipped = want_gn > grad_clip
        assert clipped == (grad_clip == 1.0)
        gap = abs(got_gn - want_gn) / want_gn if clipped else 0.0
        gaps = max(gaps, gap) if i else gap
        assert int(st["step"]) == int(rst["step"]) == i + 1
        for name, k in (("m", 1), ("v", 2)):
            for got, want in zip(tree_flatten(st[name])[0],
                                 jax.tree.leaves(rst[name])):
                assert got.dtype == torch.float32
                assert rel_err(got.numpy(), want) <= TOL + k * gaps, (name, i)
        for got, want in zip(tree_flatten(params)[0], jax.tree.leaves(rp)):
            want = np.asarray(want)
            if want.dtype == jnp.bfloat16:
                assert got.dtype == torch.bfloat16
                gb = got.view(torch.int16).numpy().astype(np.int32)
                wb = want.view(np.int16).astype(np.int32)
                assert np.abs(gb - wb).max() <= 1, i   # one bf16 ulp
            else:
                assert rel_err(got.numpy(), want) <= TOL, i
        if lr_scale == 0.0:  # the first train step: no parameter moves
            for got, want in zip(tree_flatten(params)[0],
                                 tree_flatten(params_from_numpy(p_np, device="cpu"))[0]):
                assert torch.equal(got, want)


def test_adamw_updates_in_place():
    params = params_from_numpy(nested_tree(0, 0.5), device="cpu")
    st = adamw_init(params)
    leaves = tree_flatten(params)[0]
    moments = tree_flatten(st["m"])[0]
    new_p, new_st, _ = adamw_update(AdamWConfig(), params,
                                    params_from_numpy(nested_tree(1, 1.0), device="cpu"),
                                    st, 1.0)
    assert all(a is b for a, b in zip(tree_flatten(new_p)[0], leaves))
    assert all(a is b for a, b in zip(tree_flatten(new_st["m"])[0], moments))
    assert int(st["step"]) == 0 and int(new_st["step"]) == 1


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def test_compress_nested_tree_matches_reference():
    g_np = jax.tree.map(lambda a: np.asarray(a, np.float32), nested_tree(3, 0.2))
    grads = params_from_numpy(g_np, device="cpu")
    out, err, ratio = compress_grads(grads, "none")
    assert out is grads and err is None and ratio == 1.0
    want, _, _ = ref_compress(as_jax(g_np), "bf16")
    out, err, ratio = compress_grads(grads, "bf16")
    assert ratio == 2.0 and err is None
    for a, b in zip(tree_flatten(out)[0], jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # int8: from a zero residual, then from the one it returned
    r_err, err = None, None
    for i in range(2):
        g_np = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            nested_tree(4 + i, 0.2))
        want, r_err, _ = ref_compress(as_jax(g_np), "int8", r_err)
        out, err, ratio = compress_grads(params_from_numpy(g_np, device="cpu"),
                                         "int8", err)
        assert ratio == 4.0
        assert list(out) == list(g_np) and list(out["sb"]["slot0"]) == ["attn", "ln"]
        for a, b in zip(tree_flatten(out)[0], jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_flatten(err)[0], jax.tree.leaves(r_err)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compress_flat_dict_unchanged():
    """The GS trainer's call: a flat dict of float32 tensors, in its key
    order, bit-equal to the reference."""
    r = np.random.default_rng(5)
    g_np = {k: (r.normal(size=s) * 0.1).astype(np.float32)
            for k, s in (("means", (40, 3)), ("log_scales", (40, 3)),
                         ("colors", (40, 3)), ("opacity_logit", (40,)))}
    grads = {k: torch.from_numpy(v.copy()) for k, v in g_np.items()}
    for mode in ("bf16", "int8"):
        want, w_err, _ = ref_compress({k: jnp.asarray(v) for k, v in g_np.items()},
                                      mode)
        out, err, _ = compress_grads(grads, mode)
        assert list(out) == list(g_np)
        for k in g_np:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
            if mode == "int8":
                np.testing.assert_array_equal(err[k].numpy(), np.asarray(w_err[k]))
    with pytest.raises(ValueError):
        compress_grads(grads, "int8", {"means": grads["means"]})
