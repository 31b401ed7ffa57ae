"""The port's flash attention backward and remat.

``flash_attention(impl="vjp")`` (``models.layers._FlashVJP``, the
recomputing backward) against the reference's custom VJP and against the
port's own ``impl="scan"`` (autograd through the chunk loop) on the seven
``CASES`` of ``tests/test_flash_vjp.py``: 2e-5 forward, 5e-4 on dq, dk and
dv, that test's bounds.  The dispatch (a ``kv_len_mask`` or a tensor offset
takes the loop), what each path saves for the backward, the h2o-danube
train step under both impls (``tests/test_flash_vjp.py:62-90``) and
``remat=True`` against ``remat=False`` (1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.models import (TrainCfg, init_opt_state, init_params,  # noqa: E402
                                layers, make_train_step)
from repro_torch.models.steps import forward_train  # noqa: E402
from repro_torch.runtime.checkpoint import tree_flatten  # noqa: E402

CASES = [
    # (B, Sq, Skv, Hq, Hkv, hd, causal, window, prefix, kv_chunk)
    (2, 16, 16, 4, 4, 8, True, None, 0, 8),
    (2, 16, 16, 4, 2, 8, True, None, 0, 8),     # GQA
    (1, 32, 32, 4, 1, 8, True, 8, 0, 16),       # MQA + SWA
    (2, 16, 16, 4, 4, 8, True, None, 6, 8),     # prefix-LM
    (1, 12, 20, 2, 2, 8, False, None, 0, 8),    # cross-attn, ragged chunk
    (1, 16, 16, 4, 4, 8, True, None, 0, 16),    # single chunk
    (2, 8, 24, 4, 2, 16, True, None, 0, 10),    # Skv % chunk != 0
]
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def make_qkvg(case):
    """``tests/test_flash_vjp.py``'s inputs: q, k, v from seed 0, the
    cotangent from seed 1 (float32 numpy)."""
    B, Sq, Skv, Hq, Hkv, hd = case[:6]
    r = np.random.default_rng(0)
    q = (r.normal(size=(B, Sq, Hq, hd)) * 0.5).astype(np.float32)
    k = (r.normal(size=(B, Skv, Hkv, hd)) * 0.5).astype(np.float32)
    v = (r.normal(size=(B, Skv, Hkv, hd)) * 0.5).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(B, Sq, Hq, hd)).astype(np.float32)
    return q, k, v, g


def kwargs(case):
    causal, window, prefix, chunk = case[6:]
    return dict(causal=causal, window=window, prefix_len=prefix, kv_chunk=chunk)


def port_grads(q, k, v, g, impl, **kw):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = layers.flash_attention(*ts, impl=impl, **kw)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts], out.grad_fn


def ref_grads(q, k, v, g, impl, **kw):
    q, k, v, g = map(jnp.asarray, (q, k, v, g))
    out, vjp = jax.vjp(
        lambda q, k, v: ref_layers.flash_attention(q, k, v, impl=impl, **kw),
        q, k, v)
    return np.asarray(out), [np.asarray(d) for d in vjp(g)]


def assert_close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_vjp_matches_reference_and_scan(case):
    q, k, v, g = make_qkvg(case)
    kw = kwargs(case)
    want_out, want_d = ref_grads(q, k, v, g, "vjp", **kw)
    out, d, fn = port_grads(q, k, v, g, "vjp", **kw)
    assert type(fn).__name__ == "_FlashVJPBackward"
    assert_close(out, want_out, FWD_TOL, f"forward {case}")
    for a, b, name in zip(d, want_d, "qkv"):
        assert a.shape == b.shape
        assert_close(a, b, GRAD_TOL, f"d{name} vs reference {case}")
    s_out, s_d, s_fn = port_grads(q, k, v, g, "scan", **kw)
    assert type(s_fn).__name__ != "_FlashVJPBackward"
    np.testing.assert_array_equal(out, s_out)    # one forward
    for a, b, name in zip(d, s_d, "qkv"):
        assert_close(a, b, GRAD_TOL, f"d{name} vs scan {case}")


def test_mask_and_tensor_offset_take_the_loop():
    """A ``kv_len_mask`` or a tensor offset under ``impl="vjp"`` runs
    autograd through the loop, as the reference falls back to its scan:
    the same gradients as ``impl="scan"``, and as the reference's."""
    case = CASES[1]
    q, k, v, g = make_qkvg(case)
    kw = kwargs(case)
    mask = np.ones((case[0], case[2]), bool)
    mask[0, -5:] = False
    routes = {
        "mask": (dict(kv_len_mask=torch.from_numpy(mask)),
                 dict(kv_len_mask=jnp.asarray(mask))),
        "offset": (dict(q_offset=torch.tensor(3), kv_offset=torch.tensor(3)),
                   dict(q_offset=jnp.int32(3), kv_offset=jnp.int32(3))),
    }
    for name, (port_kw, ref_kw) in routes.items():
        out, d, fn = port_grads(q, k, v, g, "vjp", **kw, **port_kw)
        assert type(fn).__name__ != "_FlashVJPBackward", name
        s_out, s_d, _ = port_grads(q, k, v, g, "scan", **kw, **port_kw)
        np.testing.assert_array_equal(out, s_out)
        for a, b in zip(d, s_d):
            np.testing.assert_array_equal(a, b)
        want_out, want_d = ref_grads(q, k, v, g, "vjp", **kw, **ref_kw)
        assert_close(out, want_out, FWD_TOL, name)
        for a, b in zip(d, want_d):
            assert_close(a, b, GRAD_TOL, name)


def test_vjp_saves_no_quadratic_tensor():
    """Saved for the backward, per (batch, head): the vjp path keeps
    (q, k, v, out, m, l) -- O(S * hd) -- and nothing with Sq * Skv
    elements; the scan path keeps every chunk's probabilities, Sq * Skv in
    all."""
    B, S, H, hd, chunk = 1, 64, 2, 8, 16
    r = np.random.default_rng(2)
    qkv = [torch.from_numpy(r.normal(size=(B, S, H, hd)).astype(np.float32))
           .requires_grad_() for _ in range(3)]

    def saved(impl):
        sizes = []

        def pack(t):
            sizes.append(t.numel() // (B * H))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            layers.flash_attention(*qkv, impl=impl, kv_chunk=chunk).sum()
        return sizes

    vjp, scan = saved("vjp"), saved("scan")
    assert len(vjp) == 6 and max(vjp) <= S * hd
    assert max(vjp) < S * S // 2
    chunk_probs = [n for n in scan if n == S * chunk]
    assert sum(chunk_probs) >= S * S
    assert sum(scan) > 4 * sum(vjp)


def danube_step(spec, impl, params, batch, cfg):
    """One train step under ``impl`` from a copy of ``params`` (the step
    updates its parameters in place) -> (loss, grad_norm)."""
    leaves, treedef = tree_flatten(params)
    p = treedef.unflatten([t.clone() for t in leaves])
    layers.set_flash_impl(impl)
    try:
        step = make_train_step(spec, cfg)
        _, _, metrics = step(p, init_opt_state(spec, p, cfg), batch)
        return float(metrics["loss"]), float(metrics["grad_norm"])
    finally:
        layers.set_flash_impl("vjp")


def test_vjp_used_in_train_step_matches_scan_loss():
    """``tests/test_flash_vjp.py:62-90`` in the port: h2o-danube's SMOKE
    (GQA + SWA) in bf16, one train step under each impl."""
    spec = get_smoke("h2o-danube-1.8b")
    params = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    cfg = TrainCfg(total_steps=4, kv_chunk=32)
    r = np.random.default_rng(1)
    batch = {n: torch.from_numpy(r.integers(0, spec.vocab, (2, 64)).astype(np.int32))
             for n in ("tokens", "labels")}
    scan = danube_step(spec, "scan", params, batch, cfg)
    vjp = danube_step(spec, "vjp", params, batch, cfg)
    assert scan[0] == pytest.approx(vjp[0], rel=1e-4)
    assert scan[1] == pytest.approx(vjp[1], rel=2e-3)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-tiny"])
def test_remat_matches_plain(arch):
    """``remat=True`` (each superblock, and whisper's encoder layers, under
    ``torch.utils.checkpoint``) against ``remat=False``: the same loss and
    gradients within 1e-6 (f32)."""
    spec = get_smoke(arch)
    params = init_params(spec, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    leaves, treedef = tree_flatten(params)
    data = SyntheticTokens(vocab=spec.vocab, seq=64, global_batch=2, seed=4)
    batch = data.batch(0, device="cpu")
    if spec.family == "encdec":
        batch["frames"] = torch.from_numpy(np.random.default_rng(3).normal(
            size=(2, 64, spec.frontend_dim)).astype(np.float32))
    out = {}
    for remat in (True, False):
        ps = [t.detach().clone().requires_grad_() for t in leaves]
        loss, aux = forward_train(spec, treedef.unflatten(ps), batch,
                                  remat=remat, kv_chunk=32)
        grads = torch.autograd.grad(loss + 0.01 * aux, ps, allow_unused=True,
                                    materialize_grads=True)
        out[remat] = (float(loss.detach()), float(aux.detach()), grads)
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-6, abs=1e-12)
    for a, b in zip(out[True][2], out[False][2]):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) / scale <= 1e-6
