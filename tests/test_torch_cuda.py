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
