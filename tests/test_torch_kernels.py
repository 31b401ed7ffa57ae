"""Port parity: the rasterizer's plain PyTorch versions against the JAX
package's Pallas kernel body (interpret mode) and its jnp oracle.

The same numpy inputs (seeded, with dead and saturated splats) go through
``repro.kernels`` and ``repro_torch.kernels``; the gate is the reference's
own forward tolerance, 1e-5 (tests/test_kernel_rasterize.py).  The CUDA
kernel itself runs only on a card: its cases are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import rasterize as jrk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, rasterize, ref  # noqa: E402

from test_torch_cuda import SWEEP, tile_inputs  # noqa: E402

TOL = 1e-5


@pytest.mark.parametrize("T,K,th,tw", SWEEP)
def test_plain_versions_match_pallas_interpret_and_ref(T, K, th, tw):
    f, o = tile_inputs(T * 100 + K, T, K, th, tw)
    pallas = np.asarray(jrk.rasterize_fwd(jnp.asarray(f), jnp.asarray(o),
                                          tile_h=th, tile_w=tw,
                                          interpret=True))
    oracle = np.asarray(jref.rasterize_tiles_ref(jnp.asarray(f),
                                                 jnp.asarray(o),
                                                 tile_h=th, tile_w=tw))
    ft, ot = torch.from_numpy(f), torch.from_numpy(o)
    for fn in (ref.rasterize_tiles_ref, ref.rasterize_tiles_unrolled):
        out = fn(ft, ot, tile_h=th, tile_w=tw).numpy()
        assert out.shape == (T, 4, th, tw) and out.dtype == np.float32
        np.testing.assert_allclose(out, pallas, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, oracle, rtol=TOL, atol=TOL)
    # the dispatcher's CPU path is the plain version
    out = ops.rasterize_tiles(ft, ot, tile_h=th, tile_w=tw).numpy()
    np.testing.assert_allclose(out, pallas, rtol=TOL, atol=TOL)


def test_saturated_front_splat_hides_the_rest():
    """A fully opaque front splat hides everything behind it (the
    reference's transmittance-saturation case)."""
    f = np.zeros((1, 16, 16), np.float32)
    f[0, 0, :9] = [8, 4, 1e-6, 0.0, 1e-6, 1.0, 0.0, 0.0, 0.999]
    f[0, 1, :9] = [8, 4, 1e-6, 0.0, 1e-6, 0.0, 1.0, 0.0, 0.9]
    o = np.zeros((1, 2), np.float32)
    out = ref.rasterize_tiles_ref(torch.from_numpy(f), torch.from_numpy(o),
                                  tile_h=8, tile_w=16).numpy()
    want = np.asarray(jrk.rasterize_fwd(jnp.asarray(f), jnp.asarray(o),
                                        tile_h=8, tile_w=16, interpret=True))
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    assert out[0, 0].min() > 0.95 and out[0, 1].max() < 0.05
    assert out[0, 3].min() > 0.98


@pytest.mark.parametrize("view_origins", [False, True])
def test_batched_matches_reference(view_origins):
    V, T, K, th, tw = 3, 2, 16, 8, 16
    f = np.stack([tile_inputs(v, T, K, th, tw)[0] for v in range(V)])
    o = tile_inputs(0, T, K, th, tw)[1]
    if view_origins:
        o = np.stack([o + 16.0 * v for v in range(V)])   # (V, T, 2)
    want = np.asarray(jops.rasterize_tiles_batched(
        jnp.asarray(f), jnp.asarray(o), tile_h=th, tile_w=tw, impl="ref"))
    out = ops.rasterize_tiles_batched(torch.from_numpy(f),
                                      torch.from_numpy(o), tile_h=th,
                                      tile_w=tw).numpy()
    assert out.shape == (V, T, 4, th, tw)
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def test_bf16_tables_promote_to_f32():
    f, o = tile_inputs(5, 2, 16, 8, 16)
    fb = torch.from_numpy(f).to(torch.bfloat16)
    out = ops.rasterize_tiles(fb, torch.from_numpy(o), tile_h=8, tile_w=16)
    assert out.dtype == torch.float32
    want = np.asarray(jops.rasterize_tiles(
        jnp.asarray(f).astype(jnp.bfloat16), jnp.asarray(o), tile_h=8,
        tile_w=16, impl="ref"))
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


def test_dispatch_on_cpu_tensors():
    f, o = (torch.from_numpy(a) for a in tile_inputs(1, 1, 4, 8, 16))
    assert ops.resolve_impl("auto", f) == "ref"
    assert ops.resolve_impl("cuda", f) == "cuda"
    with pytest.raises(ValueError):
        ops.resolve_impl("pallas", f)
    with pytest.raises(ValueError):          # the kernel needs CUDA tensors
        ops.rasterize_tiles(f, o, tile_h=8, tile_w=16, impl="cuda")
    with pytest.raises(ValueError):
        rasterize.rasterize_fwd(f, o, tile_h=8, tile_w=16)
    # the CPU path is differentiable through autograd of the plain version
    f.requires_grad_(True)
    ops.rasterize_tiles(f, o, tile_h=8, tile_w=16).sum().backward()
    assert f.grad is not None and torch.isfinite(f.grad).all()
