"""Port parity: the rasterizer's backward against the JAX package's Pallas
``rasterize_bwd`` (interpret mode) and its autodiff oracle.

The same numpy inputs (seeded, dead and saturated splats) go through both
packages.  Gates are the reference's own (tests/test_kernel_rasterize.py):
2e-4 on unsaturated inputs (`:100`), 5e-4 with saturated splats (`:145`).
The plain backward (``rasterize_bwd_ref``, autograd of the plain forward)
and the single-sweep emulation of the kernel's algorithm
(``rasterize_bwd_emulate``) are held against the Pallas body; the CUDA
kernel itself runs only on a card and its cases are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import rasterize as jrk  # noqa: E402
from repro_torch.kernels import ops, rasterize, ref  # noqa: E402

from test_torch_cuda import GRAD_SWEEP, grad_inputs  # noqa: E402

UNSAT_TOL = 2e-4
SAT_TOL = 5e-4


def pallas_bwd(f, o, gout, th, tw):
    """The reference's Pallas backward body (interpret mode) on the
    reference's own forward output -> (out, gfeats) numpy."""
    out = jrk.rasterize_fwd(jnp.asarray(f), jnp.asarray(o), tile_h=th,
                            tile_w=tw, interpret=True)
    g = jrk.rasterize_bwd(jnp.asarray(f), jnp.asarray(o), out,
                          jnp.asarray(gout), tile_h=th, tile_w=tw,
                          interpret=True)
    return np.asarray(out), np.asarray(g)


def port_bwds(f, o, out, gout, th, tw):
    args = tuple(torch.from_numpy(np.array(a)) for a in (f, o, out, gout))
    return {fn.__name__: fn(*args, tile_h=th, tile_w=tw).numpy()
            for fn in (ref.rasterize_bwd_ref, ref.rasterize_bwd_emulate)}


@pytest.mark.parametrize("T,K,th,tw", GRAD_SWEEP)
def test_plain_backward_matches_pallas_saturated(T, K, th, tw):
    f, o, gout = grad_inputs(11 + K, T, K, th, tw)
    out, want = pallas_bwd(f, o, gout, th, tw)
    for name, got in port_bwds(f, o, out, gout, th, tw).items():
        assert got.shape == (T, K, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got[..., :9], want[..., :9], rtol=SAT_TOL,
                                   atol=SAT_TOL, err_msg=name)
        assert np.abs(got[..., 9:]).max() == 0.0, name
        assert np.isfinite(got).all(), name


@pytest.mark.parametrize("T,K,th,tw", [(2, 8, 8, 16), (3, 33, 8, 32)])
def test_plain_backward_matches_pallas_unsaturated(T, K, th, tw):
    """The reference's unsaturated case (`:80`) at its 2e-4 gate; the
    emulation is also held against the autograd plain version."""
    f, o, gout = grad_inputs(2, T, K, th, tw, dead_frac=0.2, sat_frac=0.0)
    out, want = pallas_bwd(f, o, gout, th, tw)
    got = port_bwds(f, o, out, gout, th, tw)
    for name, g in got.items():
        np.testing.assert_allclose(g[..., :9], want[..., :9], rtol=UNSAT_TOL,
                                   atol=UNSAT_TOL, err_msg=name)
    np.testing.assert_allclose(got["rasterize_bwd_emulate"],
                               got["rasterize_bwd_ref"], rtol=UNSAT_TOL,
                               atol=UNSAT_TOL)


def test_empty_slots_and_padding_columns():
    """All-dead slots: geometry/colour gradients exactly 0 (only d/d alpha
    may be non-zero), as the reference's `:258` asserts; padding columns
    are 0 in every version."""
    f, o, gout = grad_inputs(3, 2, 8, 8, 16, dead_frac=1.0, sat_frac=0.0)
    out, want = pallas_bwd(f, o, gout, 8, 16)
    assert np.abs(want[..., :8]).max() == 0.0
    for name, got in port_bwds(f, o, out, gout, 8, 16).items():
        assert np.abs(got[..., :8]).max() == 0.0, name
        assert np.abs(got[..., 9:]).max() == 0.0, name
        np.testing.assert_allclose(got[..., 8], want[..., 8], rtol=UNSAT_TOL,
                                   atol=UNSAT_TOL, err_msg=name)
    # through the dispatcher's CPU path (autograd of the plain version)
    ft = torch.from_numpy(f).requires_grad_(True)
    ops.rasterize_tiles(ft, torch.from_numpy(o), tile_h=8,
                        tile_w=16).sum().backward()
    assert ft.grad[..., :8].abs().max().item() == 0.0
    assert ft.grad[..., 9:].abs().max().item() == 0.0


def test_saturated_front_splat_gradient():
    """The transmittance-saturation case (`:269`): an opaque front splat
    (opacity * g above 0.99, so its alpha gradient is masked) hides the
    splat behind it, whose gradients nearly vanish."""
    f = np.zeros((1, 16, 16), np.float32)
    f[0, 0, :9] = [8, 4, 1e-6, 0.0, 1e-6, 1.0, 0.0, 0.0, 0.999]
    f[0, 1, :9] = [8, 4, 1e-6, 0.0, 1e-6, 0.0, 1.0, 0.0, 0.9]
    o = np.zeros((1, 2), np.float32)
    gout = np.ones((1, 4, 8, 16), np.float32)
    out, want = pallas_bwd(f, o, gout, 8, 16)
    for name, got in port_bwds(f, o, out, gout, 8, 16).items():
        np.testing.assert_allclose(got, want, rtol=SAT_TOL, atol=SAT_TOL,
                                   err_msg=name)
        assert got[0, 0, 8] == 0.0, name                    # clamp mask
        assert np.abs(got[0, 1, 5:8]).max() < 0.02 * 128, name


def test_cuda_function_wiring_on_plain_versions(monkeypatch):
    """``_RasterizeCUDA`` with the kernel pair swapped for the plain
    versions (CPU tensors): the saved forward output reaches the backward,
    origins get a zero gradient and a bf16 table a bf16 cotangent -- the
    reference's custom-VJP contract (``repro/kernels/ops.py:46-51``), the
    same as its interpret-mode result."""
    calls = []

    def fake_fwd(feats, origins, *, tile_h, tile_w):
        return ref.rasterize_tiles_ref(feats, origins, tile_h=tile_h,
                                       tile_w=tile_w)

    def fake_bwd(feats, origins, out, gout, *, tile_h, tile_w):
        calls.append(out)
        return ref.rasterize_bwd_ref(feats, origins, out, gout,
                                     tile_h=tile_h, tile_w=tile_w)

    monkeypatch.setattr(rasterize, "rasterize_fwd", fake_fwd)
    monkeypatch.setattr(rasterize, "rasterize_bwd", fake_bwd)
    f, o, gout = grad_inputs(5, 2, 16, 8, 16)
    want = jax.grad(lambda x: jnp.vdot(jops.rasterize_tiles(
        x, jnp.asarray(o), tile_h=8, tile_w=16, impl="interpret"),
        jnp.asarray(gout)), argnums=0)(jnp.asarray(f))
    jgo = jax.grad(lambda y: jnp.vdot(jops.rasterize_tiles(
        jnp.asarray(f), y, tile_h=8, tile_w=16, impl="interpret"),
        jnp.asarray(gout)))(jnp.asarray(o))
    for dtype in (torch.float32, torch.bfloat16):
        ft = torch.from_numpy(f).to(dtype).requires_grad_(True)
        ot = torch.from_numpy(o).requires_grad_(True)
        out = ops._RasterizeCUDA.apply(ft.to(torch.float32), ot, 8, 16)
        out.backward(torch.from_numpy(gout))
        assert ft.grad.dtype == dtype
        assert ot.grad.abs().max().item() == 0.0 == np.abs(jgo).max()
        assert calls[-1] is not None and calls[-1].shape == out.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want),
                                       rtol=SAT_TOL, atol=SAT_TOL)


def test_bf16_cotangent_through_dispatcher():
    """A bf16 feature table gets bf16 cotangents on the CPU path too (the
    transpose of the f32 promotion), equal to the reference's ref impl
    rounded the same way."""
    f, o, gout = grad_inputs(6, 2, 16, 8, 16)
    ft = torch.from_numpy(f).to(torch.bfloat16).requires_grad_(True)
    out = ops.rasterize_tiles(ft, torch.from_numpy(o), tile_h=8, tile_w=16)
    out.backward(torch.from_numpy(gout))
    assert ft.grad.dtype == torch.bfloat16
    want = jax.grad(lambda x: jnp.vdot(jops.rasterize_tiles(
        x, jnp.asarray(o), tile_h=8, tile_w=16, impl="ref"),
        jnp.asarray(gout)))(jnp.asarray(f).astype(jnp.bfloat16))
    # the reference's bf16 impl-parity gate (test_kernel_rasterize.py:246)
    np.testing.assert_allclose(ft.grad.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=2e-3,
                               atol=2e-3)
