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


#: shared memory a block can use on Hopper: 227 KB (232,448 bytes)
MAX_SMEM_BYTES = 232_448
#: every tile shape of 1 to 1024 pixels
ALL_TILES = [(th, tw) for th in range(1, rasterize.MAX_TILE_PIXELS + 1)
             for tw in range(1, rasterize.MAX_TILE_PIXELS // th + 1)]


def test_launch_geometry_covers_every_pixel_once():
    """Every pixel of every tile is carried by exactly one (thread, slot)
    pair, and every other pair is idle (-1)."""
    for th, tw in ALL_TILES:
        slots = rasterize.slot_pixels(th, tw).flatten()
        used = slots[slots >= 0].sort().values
        assert torch.equal(used, torch.arange(th * tw)), (th, tw)


def test_launch_geometry_blocks_are_whole_warps():
    for th, tw in ALL_TILES:
        threads, ppt, _ = rasterize.launch_geometry(th, tw)
        assert threads % 32 == 0 and 32 <= threads <= 1024, (th, tw)
        assert ppt == rasterize.PIXELS_PER_THREAD
        assert threads * ppt >= th * tw > (threads - 32) * ppt, (th, tw)


def test_launch_geometry_shared_memory_fits():
    """Both kernels' dynamic shared memory fits Hopper's 227 KB a block;
    the backward's grows with the block's warps, the forward's does not."""
    for th, tw in ALL_TILES:
        for backward in (False, True):
            smem = rasterize.launch_geometry(th, tw, backward=backward)[2]
            assert 0 < smem <= MAX_SMEM_BYTES, (th, tw, backward)
    fwd = {rasterize.launch_geometry(*t).smem_bytes for t in ALL_TILES}
    assert fwd == {rasterize.FWD_CHUNK * rasterize.ROW_BYTES}


def test_launch_geometry_of_the_ports_tiles():
    """16x16 runs on 2 warps and 8x128 on 8, 4 pixels a thread, and each
    thread's pixels share a column (threads a multiple of the width)."""
    assert rasterize.launch_geometry(16, 16) == (64, 4, 6144)
    assert rasterize.launch_geometry(16, 16, backward=True) == (64, 4, 12800)
    assert rasterize.launch_geometry(8, 128) == (256, 4, 6144)
    assert rasterize.launch_geometry(8, 128, backward=True) == (256, 4, 37376)
    for th, tw in ((16, 16), (8, 128), (8, 16)):
        cols = rasterize.slot_pixels(th, tw) % tw
        assert (cols == cols[:, :1]).all()


@pytest.mark.parametrize("th,tw", [(0, 8), (8, 0), (64, 32), (1, 1025)])
def test_launch_geometry_refuses_tiles_out_of_range(th, tw):
    with pytest.raises(ValueError):
        rasterize.launch_geometry(th, tw)


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_120rasterize_bwd_kernelILb1EEEvPKfS2_iiiib
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FADD R2, R3, R4 ;
        /*0030*/                   MUFU.EX2 R5, R5 ;
        /*0040*/                   FFMA R6, R5, R4, R6 ;
        /*0050*/              @!P0 BRA 0x20 ;
        /*0060*/                   MUFU.EX2 R5, R5 ;
        /*0070*/                   SHFL.BFLY PT, R5, R5, 0x10, 0x1f ;
        /*0080*/                   MUFU.EX2 R7, R7 ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/               @P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_120rasterize_bwd_kernelILb0EEEvPKfS2_iiiib
        /*0000*/                   MUFU.EX2 R5, R5 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_hot_loop_counts_the_innermost_loop_with_an_ex2():
    """The SASS counter takes the smallest loop that issues MUFU.EX2 in
    the named function: here 0x20-0x50 (4 instructions, 1 EX2), not the
    outer 0x10-0xa0 loop nor the other instantiation's."""
    got = rasterize.hot_loop(SASS, "rasterize_bwd_kernelILb1E")
    assert got["instructions"] == 4 and got["ex2"] == 1
    assert got["per_splat_pixel"] == 4.0
    assert (got["ffma"], got["fadd"], got["bra"], got["shfl"]) == (1, 1, 1, 0)
    with pytest.raises(ValueError):
        rasterize.hot_loop(SASS, "rasterize_fwd_kernel")
