"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every case here needs an NVIDIA card and ``nvcc`` (the kernels have no CPU
mode): they carry the ``cuda`` marker and skip with a reason elsewhere.  The
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Gates: the forward at 1e-5 (the reference's, tests/test_kernel_rasterize.py);
the backward at 5e-4 against autograd of the plain forward (the reference's
saturated-case gate, `:145`) and at 2e-4 against the single-sweep emulation
of the kernel's own algorithm (the unsaturated gate, `:100`).

The seeded tile inputs below (numpy only) are shared with the CPU parity
files, ``test_torch_kernels.py`` and ``test_torch_backward.py``, which
import them from here.  Both generators lay a strip of T tiles side by
side and fill each tile's K slots with random SPD conics, dead (alpha 0)
slots and saturated splats (opacity 3, so opacity * g exceeds 0.99 near
the centre and alpha clamps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, rasterize, ref  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-5
UNSAT_TOL = 2e-4
SAT_TOL = 5e-4


#: forward sweep (T, K, th, tw): K in {1, 16, 64} on the CPU tile and the
#: reference's production (8, 128) tile
SWEEP = [
    (3, 1, 8, 16),
    (3, 16, 8, 16),
    (2, 64, 8, 16),
    (2, 1, 8, 128),
    (2, 16, 8, 128),
    (2, 64, 8, 128),
]

#: the reference's GRAD_SWEEP (tests/test_kernel_rasterize.py:108)
GRAD_SWEEP = [
    (2, 1, 8, 16),
    (2, 16, 8, 16),
    (3, 64, 8, 16),
    (2, 1, 8, 128),
    (2, 16, 8, 128),
    (2, 64, 8, 128),
]

#: the card-only sweep adds K past one shared-memory chunk of either kernel
CUDA_EXTRA = [(37, 256, 16, 16), (37, 300, 8, 128)]

#: the launch layout's edge cases (4 pixels a thread, whole warps): tiles
#: whose pixel count is not a multiple of 32 x 4 or whose threads do not
#: keep one column (1x1, 5x7), and the tiles the port uses; K at the
#: chunk edges (32 before, now 96 for the backward and 128 for the
#: forward) and the backward's groups of 3 rows
LAYOUT_TILES = [(1, 1), (5, 7), (8, 16), (16, 16), (8, 128), (32, 32)]
LAYOUT_KS = [1, 31, 32, 33, 64, 95, 96, 97, 128, 129, 256, 300]


def _splat_rows(r, T, K, th, tw):
    n = T * K
    mean = r.uniform([-4, -4], [tw * T + 4, th + 4], size=(n, 2))
    ang = r.uniform(0, np.pi, size=n)
    ia = 1.0 / r.uniform(0.8, 6.0, size=n) ** 2
    ib = 1.0 / r.uniform(0.8, 6.0, size=n) ** 2
    ca, sa = np.cos(ang), np.sin(ang)
    conic = np.stack([ca * ca * ia + sa * sa * ib, ca * sa * (ia - ib),
                      sa * sa * ia + ca * ca * ib], -1)
    rgb = r.uniform(0, 1, size=(n, 3))
    return mean, conic, rgb


def _pack(mean, conic, rgb, alpha, T, K, tw):
    n = T * K
    feat = np.concatenate([mean, conic, rgb, alpha[:, None],
                           np.zeros((n, 7))], -1)
    origins = np.stack([np.arange(T) * tw, np.zeros(T)], -1)
    return (feat.reshape(T, K, 16).astype(np.float32),
            origins.astype(np.float32))


def tile_inputs(seed, T, K, th, tw, dead_frac=0.2, sat_frac=0.2):
    """(feats (T, K, 16), origins (T, 2)) float32 numpy for the forward."""
    r = np.random.default_rng(seed)
    mean, conic, rgb = _splat_rows(r, T, K, th, tw)
    n = T * K
    alpha = r.uniform(0.05, 0.95, size=n)
    alpha[r.uniform(size=n) < sat_frac] = 3.0
    alpha[r.uniform(size=n) < dead_frac] = 0.0
    return _pack(mean, conic, rgb, alpha, T, K, tw)


def grad_inputs(seed, T, K, th, tw, *, dead_frac=0.25, sat_frac=0.2):
    """(feats (T, K, 16), origins (T, 2), gout (T, 4, th, tw)) float32
    numpy for the backward: ``sat_frac`` of the LIVE splats saturated --
    the reference's GRAD_SWEEP conditioning."""
    r = np.random.default_rng(seed)
    mean, conic, rgb = _splat_rows(r, T, K, th, tw)
    n = T * K
    alpha = r.uniform(0.05, 0.95, size=n)
    alpha[r.uniform(size=n) < dead_frac] = 0.0
    alpha[(r.uniform(size=n) < sat_frac) & (alpha > 0)] = 3.0
    feats, origins = _pack(mean, conic, rgb, alpha, T, K, tw)
    gout = r.normal(size=(T, 4, th, tw)).astype(np.float32)
    return feats, origins, gout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def on(dev, *arrays):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.parametrize("T,K,th,tw", SWEEP + CUDA_EXTRA)
def test_cuda_kernel_matches_plain_version(cuda, T, K, th, tw):
    ft, ot = on(cuda, *tile_inputs(T * 100 + K, T, K, th, tw))
    before = rasterize.LAUNCHES
    out = ops.rasterize_tiles(ft, ot, tile_h=th, tile_w=tw)
    assert rasterize.LAUNCHES == before + 1
    plain = ref.rasterize_tiles_ref(ft, ot, tile_h=th, tile_w=tw)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(),
                               rtol=TOL, atol=TOL)


def test_cuda_kernel_refuses_plain_path_and_fake_backward(cuda):
    """No plain version on CUDA tensors, forward or backward: the backward
    of ``ops.rasterize_tiles`` launches the ``rasterize_bwd`` kernel once
    and matches ``rasterize_bwd_ref``."""
    f, o = on(cuda, *tile_inputs(2, 2, 8, 8, 16))
    with pytest.raises(ValueError):
        ops.rasterize_tiles(f, o, tile_h=8, tile_w=16, impl="ref")
    with pytest.raises(ValueError):          # 64 x 32 = 2048 > 1024 threads
        rasterize.rasterize_fwd(f, o, tile_h=64, tile_w=32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gout = torch.randn((2, 4, 8, 16), generator=gen, device=cuda)
    x = f.clone().requires_grad_(True)
    fwd, bwd = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
    out = ops.rasterize_tiles(x, o, tile_h=8, tile_w=16)
    out.backward(gout)
    assert (rasterize.LAUNCHES, rasterize.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    want = ref.rasterize_bwd_ref(f, o, out.detach(), gout, tile_h=8,
                                 tile_w=16)
    np.testing.assert_allclose(x.grad.cpu().numpy(), want.cpu().numpy(),
                               rtol=SAT_TOL, atol=SAT_TOL)


@pytest.mark.parametrize("T,K,th,tw", GRAD_SWEEP + CUDA_EXTRA)
def test_cuda_backward_matches_plain_version(cuda, T, K, th, tw):
    ft, ot, gt = on(cuda, *grad_inputs(11 + K, T, K, th, tw))
    out = rasterize.rasterize_fwd(ft, ot, tile_h=th, tile_w=tw)
    before = rasterize.BWD_LAUNCHES
    got = rasterize.rasterize_bwd(ft, ot, out, gt, tile_h=th, tile_w=tw)
    assert rasterize.BWD_LAUNCHES == before + 1
    again = rasterize.rasterize_bwd(ft, ot, out, gt, tile_h=th, tile_w=tw)
    plain = ref.rasterize_bwd_ref(ft, ot, out, gt, tile_h=th, tile_w=tw)
    emul = ref.rasterize_bwd_emulate(ft, ot, out, gt, tile_h=th, tile_w=tw)
    assert torch.equal(got, again)            # fixed reduction order
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=SAT_TOL, atol=SAT_TOL)
    np.testing.assert_allclose(got.cpu().numpy(), emul.cpu().numpy(),
                               rtol=UNSAT_TOL, atol=UNSAT_TOL)
    assert got[..., 9:].abs().max().item() == 0.0
    dead = ft[..., 8] == 0                    # dead slots: only d/d opacity
    assert got[..., :8][dead].abs().max().item() == 0.0


@pytest.mark.parametrize("K", LAYOUT_KS)
@pytest.mark.parametrize("th,tw", LAYOUT_TILES)
def test_cuda_launch_layout_edges(cuda, th, tw, K):
    """Both kernels on the layout's edge cases: the forward within 1e-5 of
    both plain versions, the backward within 2e-4 of the emulation of its
    algorithm, the same from run to run, padding columns and dead slots
    exactly 0.  Against autograd of the plain forward it is held at 5e-4 on
    every element where the algorithm itself (the emulation) holds that
    gate -- all of them up to the reference's K = 64; past it, with
    saturated splats (1 - alpha = 0.01), the suffix recovery's own
    cancellation can cross it, and no kernel of this algorithm can then be
    closer."""
    T = 3
    ft, ot, gt = on(cuda, *grad_inputs(1000 + 10 * K + th, T, K, th, tw))
    out = rasterize.rasterize_fwd(ft, ot, tile_h=th, tile_w=tw)
    for fn in (ref.rasterize_tiles_ref, ref.rasterize_tiles_unrolled):
        np.testing.assert_allclose(
            out.cpu().numpy(),
            fn(ft, ot, tile_h=th, tile_w=tw).cpu().numpy(), rtol=TOL,
            atol=TOL)
    got = rasterize.rasterize_bwd(ft, ot, out, gt, tile_h=th, tile_w=tw)
    again = rasterize.rasterize_bwd(ft, ot, out, gt, tile_h=th, tile_w=tw)
    assert torch.equal(got, again)
    plain = ref.rasterize_bwd_ref(ft, ot, out, gt, tile_h=th, tile_w=tw)
    emul = ref.rasterize_bwd_emulate(ft, ot, out, gt, tile_h=th, tile_w=tw)
    np.testing.assert_allclose(got.cpu().numpy(), emul.cpu().numpy(),
                               rtol=UNSAT_TOL, atol=UNSAT_TOL)
    held = (emul - plain).abs() <= SAT_TOL * (1 + plain.abs())
    assert K > 64 or held.all()
    np.testing.assert_allclose(got[held].cpu().numpy(),
                               plain[held].cpu().numpy(), rtol=SAT_TOL,
                               atol=SAT_TOL)
    assert got[..., 9:].abs().max().item() == 0.0
    dead = ft[..., 8] == 0
    if dead.any():
        assert got[..., :8][dead].abs().max().item() == 0.0


def test_cuda_kernels_refuse_another_layout(cuda):
    """The C entry points take only ``launch_geometry``'s layout: a block
    of another size, another pixels-per-thread or too little shared memory
    is refused (cudaErrorInvalidValue), and the wrapper raises."""
    libs = rasterize._load()
    ft, ot = on(cuda, *tile_inputs(3, 2, 8, 16, 16))
    out = torch.empty((2, 4, 16, 16), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    threads, ppt, smem = rasterize.launch_geometry(16, 16)
    for bad in ((threads * 2, ppt, smem), (threads, 1, smem),
                (threads, ppt, smem - 4)):
        err = libs["fwd"](ft.data_ptr(), ot.data_ptr(), out.data_ptr(), 2, 8,
                          16, 16, 16, *bad, stream)
        assert err == 1                       # cudaErrorInvalidValue
    assert libs["fwd"](ft.data_ptr(), ot.data_ptr(), out.data_ptr(), 2, 8,
                       16, 16, 16, threads, ppt, smem, stream) == 0


@pytest.mark.parametrize("F,offset", [(9, 0), (16, 1)])
def test_cuda_rows_staged_one_float_at_a_time(cuda, F, offset):
    """A table whose rows are not whole 16-byte units (F = 9), or that
    starts off a 16-byte boundary, is staged one float at a time: both
    kernels give the same bits as on the 16-byte path."""
    T, K, th, tw = 5, 100, 16, 16
    ft, ot, gt = on(cuda, *grad_inputs(77, T, K, th, tw))
    flat = torch.zeros(T * K * F + offset, device=cuda)
    other = flat[offset:].view(T, K, F)
    other.copy_(ft[..., :F])
    assert (other.data_ptr() % 16 != 0) == bool(offset)
    out = rasterize.rasterize_fwd(ft, ot, tile_h=th, tile_w=tw)
    assert torch.equal(rasterize.rasterize_fwd(other, ot, tile_h=th,
                                               tile_w=tw), out)
    got = rasterize.rasterize_bwd(other, ot, out, gt, tile_h=th, tile_w=tw)
    want = rasterize.rasterize_bwd(ft, ot, out, gt, tile_h=th, tile_w=tw)
    assert torch.equal(got, want[..., :F])


def test_cuda_dispatcher_backward_launches_kernel(cuda):
    """The kernel pair's custom-VJP contract on the card: one
    ``rasterize_bwd`` launch per backward, a zero origins gradient and the
    cotangent in the table's dtype (f32 and bf16)."""
    ft, ot, gt = on(cuda, *grad_inputs(2, 2, 8, 8, 16))
    for dtype in (torch.float32, torch.bfloat16):
        x = ft.detach().to(dtype).requires_grad_(True)
        y = ot.clone().requires_grad_(True)
        before = rasterize.BWD_LAUNCHES
        out = ops.rasterize_tiles(x, y, tile_h=8, tile_w=16)
        out.backward(gt)
        assert rasterize.BWD_LAUNCHES == before + 1
        assert x.grad.dtype == dtype
        assert y.grad.abs().max().item() == 0.0


def test_cuda_tiered_dispatch_matches_cpu(cuda):
    """``rasterize_tiles_tiered`` on the card: one forward and one backward
    launch per non-empty tier, none for the empty one; the image and the
    non-empty tiers' gradients equal the CPU path's (the plain versions)
    at the gates."""
    n_tiles, th, tw = 10, 8, 16
    ks = (4, 8, 16)
    ids = [np.array([7, 2, n_tiles], np.int32), np.zeros((0,), np.int32),
           np.array([0, 5, n_tiles, n_tiles], np.int32)]
    feats, origins = zip(*(tile_inputs(30 + k, len(i), k, th, tw)
                           for k, i in zip(ks, ids)))
    gout = np.random.default_rng(9).normal(
        size=(n_tiles, 4, th, tw)).astype(np.float32)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        tf = [torch.from_numpy(f).to(dev).requires_grad_(True) for f in feats]
        fwd, bwd = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
        img = ops.rasterize_tiles_tiered(
            tf, [torch.from_numpy(o).to(dev) for o in origins],
            [torch.from_numpy(i).to(dev) for i in ids], n_tiles, tile_h=th,
            tile_w=tw)
        img.backward(torch.from_numpy(gout).to(dev))
        launched = (rasterize.LAUNCHES - fwd, rasterize.BWD_LAUNCHES - bwd)
        got[dev.type] = (img.detach().cpu().numpy(),
                         [t.grad.cpu().numpy() for t in tf if len(t)],
                         launched)
    (img_d, g_d, n_d), (img_c, g_c, n_c) = got["cuda"], got["cpu"]
    assert n_d == (2, 2) and n_c == (0, 0)
    np.testing.assert_allclose(img_d, img_c, rtol=TOL, atol=TOL)
    for a, b in zip(g_d, g_c):
        np.testing.assert_allclose(a, b, rtol=SAT_TOL, atol=SAT_TOL)
    # padding slots (the sentinel id) get no gradient
    assert np.abs(g_d[0][2]).max() == 0.0 and np.abs(g_d[1][2:]).max() == 0.0
