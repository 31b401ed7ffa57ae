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

import json
import os

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


def _tiny_fit(dev):
    """A 128-splat sphere-shell model with free slots, a 2-view 32x32 rig,
    grey GT and the trainer cfg of the reference's checkpoint tests."""
    from repro_torch.core.cameras import orbital_rig
    from repro_torch.core.gaussians import from_points
    from repro_torch.core.train import GSTrainCfg
    from repro_torch.data.isosurface import point_cloud_for

    pts, cols = point_cloud_for("sphere_shell", 128)
    g = from_points(pts[:128], cols[:128], capacity=192, opacity=0.7,
                    device=dev)
    cams = orbital_rig(2, (0.5, 0.5, 0.5), 1.6, width=32, height=32,
                       device=dev)
    cfg = GSTrainCfg(K=8, tile_h=8, tile_w=16, lr_colors=5e-2, max_new=32,
                     densify_grad_thresh=1e-9)
    return g, cams, torch.full((2, 32, 32, 3), 0.5, device=dev), cfg


def test_cuda_cost_analysis_sees_kernel_launches(cuda):
    """``launch.cost_analysis.analyze`` over one tiered train step of the
    tiny scene on the card: no dispatcher op stands for a compositor launch
    (``ctypes``), so each is recorded by its wrapper and appears in
    ``per_op`` under the kernel's name, as many times as the launch
    counters rose, charged a whole number of its operations a splat-pixel
    (27 / 85) and none of them ``matmul_flops``."""
    from repro_torch.core.tiling import TileGrid
    from repro_torch.core.train import init_opt, make_train_step
    from repro_torch.launch.cost_analysis import KERNEL_OPS, analyze

    g, cams, gts, cfg = _tiny_fit(cuda)
    step = make_train_step(cfg, TileGrid(32, 32, cfg.tile_h, cfg.tile_w),
                           1.0)
    fwd, bwd = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
    r = analyze(step, g, init_opt(g), cams, gts)
    launched = {"rasterize_fwd": rasterize.LAUNCHES - fwd,
                "rasterize_bwd": rasterize.BWD_LAUNCHES - bwd}
    assert rasterize.RECORDER is None
    assert min(launched.values()) > 0
    kernel_flops = 0.0
    for name, n in launched.items():
        row = r["per_op"][name]
        assert row["count"] == n
        assert row["flops"] > 0 and row["flops"] % KERNEL_OPS[name] == 0
        assert row["bytes"] > 0
        kernel_flops += row["flops"]
    assert r["matmul_flops"] + kernel_flops <= r["flops"]


def test_cuda_prefetcher_side_stream_renders_equal(cuda):
    """``prepare_timestep`` run by ``TimestepPrefetcher`` on its own stream
    gives the GT renders and masks of the same call on the main stream,
    bit for bit, while the main stream is kept busy; the forward kernel
    launched from the worker."""
    from repro_torch.configs.gs_datasets import get_gs_dataset
    from repro_torch.core import pipeline as tpl
    from repro_torch.core.cameras import orbital_rig
    from repro_torch.core.tiling import TileGrid

    ds = get_gs_dataset("sphere_shell", "cpu")
    pts, _, ext = tpl.build_scene(ds, 0)
    center = 0.5 * (pts.max(0) + pts.min(0))
    cams = orbital_rig(4, center, 1.6 * ext / 2 + 1e-3, width=64, height=64,
                       device=cuda)
    grid = TileGrid(64, 64, 8, 16)
    kw = dict(t=0.1, n_parts=2, capacity=1500, K=16, device=cuda)
    main = tpl.prepare_timestep(ds, cams, grid, **kw)
    busy = torch.randn(2048, 2048, device=cuda)
    f0 = rasterize.LAUNCHES
    with tpl.TimestepPrefetcher(cuda) as pf:
        pf.submit(tpl.prepare_timestep, ds, cams, grid, **kw)
        for _ in range(20):
            busy = busy @ busy / 2048.0
        side = pf.get()
    assert rasterize.LAUNCHES > f0
    assert torch.equal(side.gts, main.gts)
    assert torch.equal(side.masks, main.masks)
    for a, b in zip(side.g0, main.g0):
        assert torch.equal(a, b)
    assert torch.isfinite(busy).all()


def test_cuda_coarse_assignment_matches_dense(cuda):
    """``assign_tiles(coarse=)`` on the card: bit for bit on live slots
    against the dense sweep when its budget covers every superblock, and
    the counter equal to the dropped pairs when it does not."""
    from repro_torch.core.projection import Splats2D
    from repro_torch.core.tiling import (NEG, TileGrid, _coarse_budget,
                                         assign_tiles, coarse_candidates)

    r = np.random.default_rng(11)
    n, res = 20000, 256
    grid = TileGrid(res, res, 8, 16)
    splats = Splats2D(
        mean2d=torch.from_numpy(r.uniform(-12, res + 12, (n, 2))
                                .astype(np.float32)),
        cov2d=torch.ones((n, 3)),
        depth=torch.from_numpy(r.uniform(0.1, 10.0, n).astype(np.float32)),
        rgb=torch.zeros((n, 3)), alpha=torch.full((n,), 0.5),
        radius=torch.from_numpy(r.uniform(0.5, 9.0, n).astype(np.float32)),
        valid=torch.from_numpy(r.uniform(size=n) > 0.1))
    dev = Splats2D(*(f.to(cuda) for f in splats))
    cand, ov = coarse_candidates(dev.mean2d, dev.radius, dev.valid, grid,
                                 sb=4, budget=n)
    assert int(ov) == 0
    occ = int((cand < n).sum(1).max())
    di, ds = assign_tiles(dev, grid, K=32)
    ci, cs, cov = assign_tiles(dev, grid, K=32, coarse=4, coarse_budget=occ,
                               return_overflow=True)
    assert int(cov) == 0 and torch.equal(cs, ds)
    live = ds > NEG / 2
    assert torch.equal(ci[live], di[live])
    hi, hs = assign_tiles(splats, grid, K=32, coarse=4, coarse_budget=occ)
    assert torch.equal(hs, cs.cpu()) and torch.equal(hi, ci.cpu())
    budget = _coarse_budget(n, (res // 16 // 4) * (res // 8 // 4), 32,
                            occ // 2)
    _, _, starved = assign_tiles(dev, grid, K=32, coarse=4,
                                 coarse_budget=occ // 2,
                                 return_overflow=True)
    want = int((cand < n).sum(1).sub(budget).clamp(min=0).sum())
    assert int(starved) == want > 0


def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """A (g, opt) tree on the card saves and restores onto the card, every
    leaf equal."""
    from repro_torch.core.train import init_opt
    from repro_torch.runtime.checkpoint import CheckpointManager, tree_flatten

    g, *_ = _tiny_fit(cuda)
    opt = init_opt(g)
    opt = opt._replace(m={k: torch.randn_like(x) for k, x in opt.m.items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, (g, opt))
    got, _ = mgr.restore(4, (g, init_opt(g)))
    want_leaves, got_leaves = tree_flatten((g, opt))[0], tree_flatten(got)[0]
    assert len(got_leaves) == 20
    for a, b in zip(got_leaves, want_leaves):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_cuda_resumed_fit_partition(cuda, tmp_path):
    """Interrupted after step 3 and resumed to 6 on the card: both kernels
    launch on every resumed step, and the tail's losses are within 1e-3
    relative of the uninterrupted run's (the gather transpose's atomics
    make two card runs differ)."""
    from repro_torch.core.tiling import TileGrid
    from repro_torch.core.train import fit_partition
    from repro_torch.runtime.checkpoint import CheckpointManager

    g, cams, gts, cfg = _tiny_fit(cuda)
    kw = dict(steps=6, extent=1.0, densify_every=2, densify_from=0,
              grid=TileGrid(32, 32, 8, 16), ckpt_every=3)

    def gen():
        return torch.Generator(device=cuda).manual_seed(11)

    _, _, full = fit_partition(g, cams, gts, None, cfg, generator=gen(),
                               **kw)
    mgr = CheckpointManager(str(tmp_path))
    fit_partition(g, cams, gts, None, cfg, generator=gen(), ckpt=mgr,
                  **{**kw, "steps": 3})
    fwd, bwd = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
    _, _, tail = fit_partition(g, cams, gts, None, cfg, generator=gen(),
                               ckpt=mgr, **kw)
    fwd, bwd = rasterize.LAUNCHES - fwd, rasterize.BWD_LAUNCHES - bwd
    assert len(tail) == 3 and fwd == bwd >= 3
    np.testing.assert_allclose(tail, full[3:], rtol=1e-3, atol=0)


def test_cuda_fit_partitions_nccl_matches_cpu_gloo(cuda):
    """``fit_partitions`` at world size 1 on the card (NCCL) and on the CPU
    (gloo), the same two-partition model and injected split noise: both
    kernels launch on every card step, and the losses agree within 1e-3
    relative (the card's reduction order and atomics, fed through Adam)."""
    from repro_torch.core.distributed import fit_partitions
    from repro_torch.core.tiling import TileGrid
    from repro_torch.launch import mesh as mesh_mod

    noise = [np.random.default_rng(e).normal(size=(2, 32, 3)).astype("f4")
             for e in range(2)]
    losses, launches = {}, None
    for dev in (cuda, "cpu"):
        on_card = torch.device(dev).type == "cuda"
        g, cams, gts, cfg = _tiny_fit(dev)
        g2 = type(g)(*(torch.stack([f, f]) for f in g))
        rank, world, _ = mesh_mod.init_distributed(dev, timeout_s=60)
        try:
            assert (rank, world) == (0, 1)
            mesh = mesh_mod.make_mesh((1, 1), ("part", "view"))
            assert mesh.backend == ("nccl" if on_card else "gloo")
            fwd, bwd = rasterize.LAUNCHES, rasterize.BWD_LAUNCHES
            _, _, losses[str(dev)] = fit_partitions(
                g2, cams, torch.stack([gts, gts]), None, cfg, mesh=mesh,
                steps=4, extent=1.0, densify_every=2, densify_from=0,
                grid=TileGrid(32, 32, 8, 16), densify_noise=noise)
            if on_card:
                launches = (rasterize.LAUNCHES - fwd,
                            rasterize.BWD_LAUNCHES - bwd)
        finally:
            mesh_mod.destroy_distributed()
    assert launches[0] == launches[1] >= 4
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-3,
                               atol=0)


def test_cuda_fit_partitions_nccl_2x2_matches_world_one(cuda, tmp_path):
    """``fit_partitions`` on a 2x2 ("part", "view") NCCL mesh of four cards
    against the same run on one card (world size 1), each a set of spawned
    ranks: two partitions, two views a step, 6 steps with densify events
    after steps 3 and 6 (injected split noise).  Both kernels launch on
    every step of every rank; all four ranks report the same losses, and
    they agree with the one-card run within 1e-3 relative (the gradient
    sums run in another order: over two ranks' views and the "part"
    reduce-scatter instead of one scatter).  The states hold the same
    live splats, their owners and step; each trained field agrees within
    2 * steps * its learning rate, the most that Adam's near-unit steps let
    two runs whose gradients differ in rounding drift apart (a component
    whose gradient is ~0 may step either way), and 99% of its components
    within 1e-4."""
    import _torch_dist
    import _torch_dist_ranks as ranks
    from repro_torch.core.train import GSTrainCfg, group_lrs

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a 2x2 NCCL mesh)")
    rasterize.build()        # once, before the ranks load it
    steps = 6
    for shape, tag in (((2, 2), "mesh22"), ((1, 1), "mesh11")):
        _torch_dist.run_ranks(ranks.card_fit_rank, shape, tmp_path,
                              str(tmp_path), tag, steps, timeout=300.0,
                              device="cuda")
    losses = [np.load(tmp_path / f"mesh22_losses{r}.npy") for r in range(4)]
    for r in range(1, 4):
        np.testing.assert_array_equal(losses[r], losses[0])
    for tag, world in (("mesh22", 4), ("mesh11", 1)):
        for r in range(world):
            fwd, bwd = np.load(tmp_path / f"{tag}_launches{r}.npy")
            assert fwd == bwd >= steps, (tag, r, fwd, bwd)
    got, want = (np.load(tmp_path / f"{t}.npz") for t in ("mesh22", "mesh11"))
    assert len(got["losses"]) == steps
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3,
                               atol=0)
    for k in ("g_active", "g_owner", "step"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lrs = group_lrs(GSTrainCfg(lr_colors=5e-2), 1.0)
    dev = {k: np.abs(got[f"g_{k}"] - want[f"g_{k}"]) for k in lrs}
    print(f"2x2 NCCL vs one card: losses {got['losses'].tolist()} vs "
          f"{want['losses'].tolist()}; per field (max, 99th percentile) "
          f"{ {k: (d.max(), np.quantile(d, 0.99)) for k, d in dev.items()} }")
    for k, lr in lrs.items():
        assert dev[k].max() <= 2 * steps * lr, (k, dev[k].max())
        assert np.quantile(dev[k], 0.99) <= 1e-4, k


def test_cuda_pod_meshes_match_world_one(cuda, tmp_path):
    """The two full-size kingsnake partitions of the training CLI (2 x
    2.88M slots, 1024x1024, 8x16 tiles, K = 64, the auto tier ladder, 4
    views, one a step) trained one partition per pod: ``fit_partitions``
    on a ("pod", "part", "model") 2x1x1 NCCL mesh of two cards and on a
    2x1x2 mesh of four (each card half the tiles of its partition),
    against the world-1 batched run on one card, 8 steps with densify
    events after steps 4 and 8 (the same seeded split noise everywhere).  Held as
    the 2x2 case above holds its runs: both kernels launch on every step
    of every rank, every rank reports the same losses, within 1e-3
    relative of the one-card run's; the same live splats and owners; each
    trained field within 2 * steps * its learning rate and 99% of its
    components within 1e-4.  ``-s`` prints the cards' name and power limit
    and each mesh's step ms."""
    import subprocess

    import _torch_dist
    import _torch_dist_ranks as ranks
    from repro_torch.core.train import GSTrainCfg, group_lrs

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a 2x1x2 NCCL mesh)")
    rasterize.build()        # once, before the ranks load it
    scene = str(tmp_path / "scene.pt")
    extent = ranks.card_scene(scene, views=4)
    torch.cuda.empty_cache()
    steps = 8
    fit = dict(steps=steps, densify_every=4, densify_from=0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    meshes = (("one", (1, 1, 1)), ("pod", (2, 1, 1)), ("podmodel", (2, 1, 2)))
    for tag, shape in meshes:
        _torch_dist.run_ranks(ranks.card_pod_rank, shape, tmp_path, scene,
                              str(tmp_path), tag, fit, timeout=600.0,
                              device="cuda", axes=("pod", "part", "model"))
    want = np.load(tmp_path / "one.npz")
    lrs = group_lrs(GSTrainCfg(), extent)
    for tag, shape in meshes:
        recs = [np.load(tmp_path / f"{tag}_rank{r}.npz")
                for r in range(int(np.prod(shape)))]
        for r, z in enumerate(recs):
            np.testing.assert_array_equal(z["losses"], recs[0]["losses"])
            fwd, bwd = z["launches"]
            assert fwd == bwd >= steps, (tag, r, fwd, bwd)
        ms = recs[0]["step_ms"]
        print(f"{tag} {shape}: losses {recs[0]['losses'].tolist()}, step ms "
              f"{np.round(ms, 3).tolist()} (median of steps 2-{steps} "
              f"{np.median(ms[1:]):.3f}), launches per rank "
              f"{[z['launches'].tolist() for z in recs]}")
        if tag == "one":
            continue
        got = np.load(tmp_path / f"{tag}.npz")
        assert len(recs[0]["losses"]) == steps
        np.testing.assert_allclose(recs[0]["losses"],
                                   np.load(tmp_path / "one_rank0.npz")
                                   ["losses"], rtol=1e-3, atol=0)
        for k in ("active", "owner"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        dev = {k: np.abs(got[k] - want[k]) for k in lrs}
        print(f"{tag} vs one card, per field (max, 99th percentile) "
              f"{ {k: (d.max(), np.quantile(d, 0.99)) for k, d in dev.items()} }")
        for k, lr in lrs.items():
            assert dev[k].max() <= 2 * steps * lr, (tag, k, dev[k].max())
            assert np.quantile(dev[k], 0.99) <= 1e-4, (tag, k)


def test_cuda_wire_meshes_nccl_match(cuda, tmp_path):
    """The wire options together -- ``gather_mode="split"``,
    ``dtype_policy="bf16"``, ``grad_compress="int8"`` -- in
    ``card_fit_rank``'s run (two partitions, two views a step, 6 steps,
    densify after steps 3 and 6, which zero the int8 residual) on a 2x2
    ("part", "view") NCCL mesh of four cards and on a ("part",) mesh of
    two.  Both kernels launch on every step of every rank; each mesh's
    ranks report the same losses, and the two meshes' agree within 1e-3
    relative (the card gate of the mesh tests: the bf16 table gradients
    sum with atomics, in another order on each mesh); the same live
    splats, owners and step; every trained field within 2 * steps * its
    learning rate, and 99% of its components within 1e-3.  The CPU twin
    at 1e-6 is ``tests/test_torch_wire.py``.  ``-s`` prints the
    deviations."""
    import _torch_dist
    import _torch_dist_ranks as ranks
    from repro_torch.core.train import GSTrainCfg, group_lrs

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a 2x2 NCCL mesh)")
    rasterize.build()        # once, before the ranks load it
    steps = 6
    wire = dict(gather_mode="split", dtype_policy="bf16", grad_compress="int8")
    for shape, axes, tag in (((2, 2), ("part", "view"), "wire22"),
                             ((2,), ("part",), "wire2")):
        _torch_dist.run_ranks(ranks.card_fit_rank, shape, tmp_path,
                              str(tmp_path), tag, steps, wire, timeout=300.0,
                              device="cuda", axes=axes)
    for tag, world in (("wire22", 4), ("wire2", 2)):
        losses = [np.load(tmp_path / f"{tag}_losses{r}.npy")
                  for r in range(world)]
        for r in range(world):
            np.testing.assert_array_equal(losses[r], losses[0])
            fwd, bwd = np.load(tmp_path / f"{tag}_launches{r}.npy")
            assert fwd == bwd >= steps, (tag, r, fwd, bwd)
    got, want = (np.load(tmp_path / f"{t}.npz") for t in ("wire22", "wire2"))
    assert len(got["losses"]) == steps and np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3,
                               atol=0)
    for k in ("g_active", "g_owner", "step"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lrs = group_lrs(GSTrainCfg(lr_colors=5e-2), 1.0)
    dev = {k: np.abs(got[f"g_{k}"] - want[f"g_{k}"]) for k in lrs}
    print(f"wire 2x2 vs 2x1 NCCL: losses {got['losses'].tolist()} vs "
          f"{want['losses'].tolist()}; per field (max, 99th percentile) "
          f"{ {k: (d.max(), np.quantile(d, 0.99)) for k, d in dev.items()} }")
    for k, lr in lrs.items():
        assert dev[k].max() <= 2 * steps * lr, (k, dev[k].max())
        assert np.quantile(dev[k], 0.99) <= 1e-3, k


def test_cuda_part_mesh_wire_layouts(cuda, tmp_path):
    """The training CLI's two full-size kingsnake partitions (2 x 2.88M
    slots, 1024x1024, 8x16 tiles, 4 views, one a step) on a ("part",) mesh
    of four NCCL cards, each holding a quarter of every partition's slots:
    the "part" all-gather and its reduce-scatter of each wire table layout
    (f32 / bf16 policy x f32 / split tables) timed alone with CUDA events,
    then ``fit_partitions`` for 5 steps with the f32 tables and with split
    + bf16.  Both kernels launch on every step of every rank; the ranks
    report the same losses; every loss is finite.  ``-s`` prints the cards'
    name and power limit, each layout's bytes a splat, rows received and
    ms, and each run's step ms and losses (the bf16 policy's loss gap is
    the reference's policy: reported, not gated)."""
    import json
    import subprocess

    import _torch_dist
    import _torch_dist_ranks as ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a ('part',) mesh of 4)")
    rasterize.build()        # once, before the ranks load it
    scene = str(tmp_path / "scene.pt")
    ranks.card_scene(scene, views=4, n_part=4)
    torch.cuda.empty_cache()
    steps = 5
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fit = dict(steps=steps, densify_every=0)
    runs = (("f32", {}), ("splitbf16", dict(gather_mode="split",
                                            dtype_policy="bf16")))
    jobs = [("card_collectives_rank", (scene, str(tmp_path)))]
    jobs += [("card_pod_rank", (scene, str(tmp_path), tag, fit, kw))
             for tag, kw in runs]
    _torch_dist.run_ranks(ranks.jobs_rank, (4,), tmp_path, jobs,
                          timeout=900.0, device="cuda", axes=("part",))
    with open(tmp_path / "collectives.json") as f:
        coll = json.load(f)
    for layout, c in coll.items():
        print(f"part x4 {layout}: {c['bytes_per_splat']} B a splat, "
              f"{c['rows_received']} rows received "
              f"({c['rows_received'] * c['bytes_per_splat'] / 1e6:.1f} MB), "
              f"all-gather {c['all_gather_ms']:.4f} ms, reduce-scatter "
              f"{c['reduce_scatter_ms']:.4f} ms")
    assert {k: c["bytes_per_splat"] for k, c in coll.items()} == {
        "f32/f32": 76, "f32/bf16": 38, "split/f32": 32, "split/bf16": 24}
    for tag, _ in runs:
        recs = [np.load(tmp_path / f"{tag}_rank{r}.npz") for r in range(4)]
        for r, z in enumerate(recs):
            np.testing.assert_array_equal(z["losses"], recs[0]["losses"])
            fwd, bwd = z["launches"]
            assert fwd == bwd >= steps, (tag, r, fwd, bwd)
        assert len(recs[0]["losses"]) == steps
        assert np.isfinite(recs[0]["losses"]).all()
        ms = recs[0]["step_ms"]
        print(f"part x4 {tag}: losses {recs[0]['losses'].tolist()}, step ms "
              f"{np.round(ms, 3).tolist()} (median of steps 2-{steps} "
              f"{np.median(ms[1:]):.3f})")


def test_cuda_part_mesh_exchange(cuda, tmp_path):
    """The sparse-overlap exchange across four NCCL cards: the training
    CLI's two full-size kingsnake partitions (2 x 2.88M slots, 1024x1024,
    8x16 tiles, 4 views, one a step) on ("part",) x4, each card a quarter
    of every partition's slots.  View 0's forward under a scalar budget, a
    probed per-edge matrix and a forced matrix (the demand with each edge
    (s, s + 1) raised to the whole shard, which moves the window
    assignment off the identity) equals the all-gather's within the card
    gate (1e-3 relative) with every counter 0; then the uniform all-to-all
    and the ladder alone (CUDA events), and ``fit_partitions`` for 5 steps
    gathered, exchanged (the budget probed per edge) and exchanged with
    the rows dealt anew every step (``rebalance_every=1``, threshold 0:
    the CLI's capacity layout puts a partition's dead slots in its last
    shard, a skew of 1.3 under the default 1.5), losses within 1e-3 of the
    gathered run's.  ``-s`` prints the cards' name and power limit, the demand
    matrix, the budgets, each shift's slab rows, the rows received a rank
    against the all-gather's, the transport ms and each run's step ms."""
    import json
    import subprocess

    import _torch_dist
    import _torch_dist_ranks as ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a ('part',) mesh of 4)")
    rasterize.build()        # once, before the ranks load it
    scene = str(tmp_path / "scene.pt")
    ranks.card_scene(scene, views=4, n_part=4)
    torch.cuda.empty_cache()
    steps = 5
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fit = dict(steps=steps, densify_every=0)
    runs = (("gather", {}, fit), ("exchange", dict(exchange=True), fit),
            ("rebalanced", dict(exchange=True),
             dict(fit, rebalance_every=1, rebalance_threshold=0.0)))
    jobs = [("card_exchange_rank", (scene, str(tmp_path)))]
    jobs += [("card_pod_rank", (scene, str(tmp_path), tag, fkw, kw))
             for tag, kw, fkw in runs]
    _torch_dist.run_ranks(ranks.jobs_rank, (4,), tmp_path, jobs,
                          timeout=900.0, device="cuda", axes=("part",))
    with open(tmp_path / "exchange.json") as f:
        ex = json.load(f)
    print(f"part x4 exchange: Nl {ex['Nl']}, demand {ex['demand']}, scalar "
          f"budget {ex['E']}, matrix {ex['B']}")
    base = ex["cases"]["gather"]["loss"]
    for name, c in ex["cases"].items():
        print(f"part x4 exchange {name}: forward loss {c['loss']:.9f} "
              f"(gather {base:.9f}), overflow {c['overflow']}"
              + (f", tau {c['tau']}, E_shift {c['E_shift']}" if "tau" in c
                 else ""))
        assert abs(c["loss"] - base) <= 1e-3 * abs(base), (name, c, base)
        for k in ("tiles", "assign", "exchange", "exchange_edges"):
            assert np.all(np.asarray(c["overflow"].get(k, 0)) == 0), (name, c)
    assert ex["cases"]["forced"]["tau"] != list(range(4))
    for name in ("all_to_all", "ladder"):
        t = ex[name]
        print(f"part x4 {name}: {t['rows_received']} rows received a rank "
              f"({t['mb_received']:.1f} MB at 76 B; the all-gather "
              f"{ex['gather_rows_received']}), transport "
              f"{t['transport_ms']:.4f} ms, with the packing "
              f"{t['move_ms']:.4f} ms")
        assert 0 < t["rows_received"] <= ex["gather_rows_received"]
    losses = {}
    for tag, _, _ in runs:
        recs = [np.load(tmp_path / f"{tag}_rank{r}.npz") for r in range(4)]
        for r, z in enumerate(recs):
            np.testing.assert_array_equal(z["losses"], recs[0]["losses"])
            fwd, bwd = z["launches"]
            assert fwd == bwd >= steps, (tag, r, fwd, bwd)
        losses[tag] = recs[0]["losses"]
        assert len(losses[tag]) == steps and np.isfinite(losses[tag]).all()
        ms = recs[0]["step_ms"]
        print(f"part x4 {tag}: losses {losses[tag].tolist()}, step ms "
              f"{np.round(ms, 3).tolist()} (median of steps 2-{steps} "
              f"{np.median(ms[1:]):.3f}), the whole fit_partitions call "
              f"{float(recs[0]['fit_s']):.3f} s")
    for tag in ("exchange", "rebalanced"):
        np.testing.assert_allclose(losses[tag], losses["gather"], rtol=1e-3,
                                   err_msg=tag)


# ---------------------------------------------------------------------------
# The training CLI under torchrun: one process per card, NCCL
# ---------------------------------------------------------------------------

#: kingsnake at full size, as the train-CLI phase of chip_smoke.py cuts it
#: (2 partitions, 1024x1024, 16 views), two views a step (the 2x2 mesh's
#: "view" axis needs them), densify after steps 4 and 8
KINGSNAKE_CLI = ["--gs", "--dataset", "kingsnake", "--full", "--parts", "2",
                 "--resolution", "1024", "--views", "16", "--view-batch", "2",
                 "--densify-every", "4", "--densify-from", "0", "--device",
                 "cuda"]
CLI_STEPS = 8
#: the card gate of the mesh tests (the gradient sums run in another order
#: and the gather transpose uses atomics): losses at 1e-3 relative, each
#: trained field within 2 * steps * its learning rate, 99% of its
#: components within 1e-4
CARD_GATES = dict(field_tol=1e-4, field_share=0.99)


def _smi():
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _torchrun_cli(nproc, argv, timeout, module="repro_torch.launch.train"):
    """``torchrun --standalone --nproc-per-node nproc -m module argv`` (the
    CLI as a user launches it, one process per card) -> its output; a
    non-zero exit raises."""
    from _torch_dist_cli import Torchrun

    out, _ = Torchrun(argv, nproc=nproc, module=module,
                      timeout=timeout).wait()
    return out


def _print_record(label, rec):
    """The per-rank numbers of a CLI record, for ``-s``."""
    from repro_torch.launch.train import record_lines

    print("\n".join(f"{label} {ln}" for ln in record_lines(rec)))


def test_cuda_torchrun_cli_meshes_match_world_one(cuda, tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --gs`` on
    the full-size kingsnake scene (2 partitions of 2.88M slots, 1024x1024,
    16 views, two a step, 8 steps, densify after steps 4 and 8), one
    process per card over NCCL on ``--mesh 4x1`` and ``--mesh 2x2``, each
    rank joining through ``env://``; against the same CLI under ``torchrun
    --nproc-per-node 1`` (world 1, one card).  Every rank launches both
    kernels; the losses agree within 1e-3 relative; the final global
    checkpoint and the merged one hold the same live splats and owners,
    each trained field within 2 * steps * its learning rate and 99% of its
    components within 1e-4 (``test_cuda_fit_partitions_nccl_2x2_matches_
    world_one``'s gates).  ``-s`` prints the cards and each run's per-rank
    ingest s, median step ms, peak GiB and launches, rank 0's merge +
    render + write s, PSNR / SSIM and checkpoint bytes."""
    from _torch_dist_cli import check_merged, check_trees, global_tree
    from repro_torch.launch.train import read_record as record
    from repro_torch.core.train import GSTrainCfg, group_lrs

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (torchrun --nproc-per-node 4)")
    rasterize.build()        # once, before the ranks load it
    print(_smi())
    recs = {}
    for tag, nproc, mesh in (("one", 1, "1x1"), ("4x1", 4, "4x1"),
                             ("2x2", 4, "2x2")):
        argv = KINGSNAKE_CLI + ["--steps", str(CLI_STEPS), "--mesh", mesh,
                                "--ckpt-dir", str(tmp_path / tag)]
        out = _torchrun_cli(nproc, argv, timeout=600)
        assert f"({nproc} ranks, nccl on cuda)" in out, out[-3000:]
        recs[tag] = rec = record(out, "[train-gs]")
        _print_record(f"kingsnake CLI {tag}", rec)
        print(f"kingsnake CLI {tag} losses {rec['losses']}")
        assert len(rec["losses"]) == CLI_STEPS
        assert np.isfinite(rec["losses"]).all()
        for r in rec["ranks"]:
            assert min(r["launches"]) >= CLI_STEPS, (tag, r)
    want = recs["one"]
    with open(tmp_path / "one" / "merged" / f"step_{CLI_STEPS:09d}"
              / "manifest.json") as f:
        extent = json.load(f)["extra"]["scene"]["extent"]
    lrs = group_lrs(GSTrainCfg(), extent)
    base = global_tree(str(tmp_path / "one"), CLI_STEPS)
    for tag in ("4x1", "2x2"):
        got = recs[tag]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3,
                                   atol=0, err_msg=tag)
        assert got["live"] == want["live"], tag
        tree = global_tree(str(tmp_path / tag), CLI_STEPS)
        n = base["means"].shape[1]
        dev = {k: np.abs(tree[k][:, :n] - base[k]) for k in lrs}
        worst = {k: (d.max(), np.quantile(d, 0.99)) for k, d in dev.items()}
        print(f"kingsnake CLI {tag} vs world 1, per field (max, 99th "
              f"percentile) {worst}")
        check_trees(tree, base, lrs, CLI_STEPS, **CARD_GATES)
        check_merged(str(tmp_path / tag), str(tmp_path / "one"), CLI_STEPS,
                     lrs, CLI_STEPS, **CARD_GATES)


def test_cuda_torchrun_timeseries_restart(cuda, tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --gs
    --timeseries`` on the full-size kingsnake scene (2 partitions, 16
    views, 4 steps a timestep, densify after step 4), the ("part",) x4
    mesh: ``--timesteps 1``, then ``--timesteps 2`` in the same directory.
    The restart resumes at timestep 1 from the chain rank 0 committed
    (every rank restores it), leaves timestep 0's commit as it was, and
    commits timestep 1 as a delta naming its base and the base's digest;
    every rank launches both kernels in both runs; every loss finite.
    ``-s`` prints the cards and each run's per-rank prep s in the worker,
    wait s in ``get()``, median step ms, peak GiB, and the chain's
    bytes."""
    import hashlib

    from repro_torch.launch.train import read_record as record
    from repro_torch.runtime.checkpoint import CheckpointManager

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (torchrun --nproc-per-node 4)")
    rasterize.build()
    print(_smi())
    S = 4
    root = tmp_path / "ts"
    argv = KINGSNAKE_CLI + ["--timeseries", "--steps", str(S), "--mesh",
                            "4x1", "--ckpt-dir", str(root)]
    head = root / "timeseries" / f"step_{S:09d}"

    def digest():
        h = hashlib.sha256()
        for f in sorted(head.iterdir()):
            h.update(f.name.encode() + f.read_bytes())
        return h.hexdigest()

    runs = []
    for T in (1, 2):
        out = _torchrun_cli(4, argv + ["--timesteps", str(T)], timeout=600)
        rec = record(out, "[train-gs-ts]")
        _print_record(f"timeseries --timesteps {T}", rec)
        print(f"timeseries --timesteps {T} losses {rec['losses']}")
        for r in rec["ranks"]:
            assert min(r["launches"]) > 0, (T, r)
        assert all(np.isfinite(x).all() and len(x) == S
                   for x in rec["losses"])
        runs.append((out, rec, digest()))
    (_, first, d0), (out, restart, d1) = runs
    assert (first["t_start"], restart["t_start"]) == (0, 1)
    assert len(first["losses"]) == len(restart["losses"]) == 1
    assert f"restarting at timestep 1 (chain committed through step {S})" \
        in out, out[-3000:]
    assert "timestep 1: warm-start from timestep 0" in out, out[-3000:]
    assert d0 == d1, "the restart rewrote timestep 0's commit"
    chain = CheckpointManager(str(root / "timeseries"), keep=0)
    assert chain.all_steps() == [S, 2 * S]
    with open(root / "timeseries" / f"step_{2 * S:09d}" / "manifest.json") as f:
        delta = json.load(f)["delta"]
    assert delta["base_step"] == S
    assert delta["base_digest"] == chain._manifest_digest(S)


def test_cuda_torchrun_rayleigh_taylor_full(cuda, tmp_path):
    """The paper's second scene at its full tier on four cards: ``torchrun
    --nproc-per-node 4 -m repro_torch.launch.train --gs --dataset
    rayleigh_taylor --full --parts 4 --resolution 1024`` with 16 views and
    80 steps (densify after steps 70 and 80), as the train-CLI phase of
    chip_smoke.py cuts kingsnake; the ("part",) x4 mesh, the all-gather
    tables.  Then ``python -m repro_torch.launch.serve_gs`` of its merged
    checkpoint on one card, 2 views, two passes.  Gates: every rank
    launches both kernels on every step; the losses finite; PSNR / SSIM
    finite; the serve exits 0 with the repeat pass all cache hits and the
    forward kernel launched.  (Not gated: that the loss falls.  On one
    card and on four this run's mean over a pass of the 16 views went
    0.0222, 0.0354, 0.0278, 0.0274, 0.0281: each view's loss jumped after
    the first pass, while the merged PSNR came out 31.49 dB; ``-s``
    prints each pass's mean.)
    ``-s`` prints the cards, the scene's point count, and per rank the
    ingest s, median step ms, peak GiB, rank 0's merge + render + write
    s, PSNR / SSIM, the checkpoints' bytes, then the serve's restore s and
    cold / warm req/s."""
    import subprocess
    import sys

    from _torch_dist_cli import SRC
    from repro_torch.launch.train import read_record as record

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (torchrun --nproc-per-node 4)")
    rasterize.build()
    print(_smi())
    steps = 80
    root = tmp_path / "rt"
    argv = ["--gs", "--dataset", "rayleigh_taylor", "--full", "--parts", "4",
            "--resolution", "1024", "--views", "16", "--steps", str(steps),
            "--densify-every", "10", "--densify-from", "60", "--device",
            "cuda", "--ckpt-dir", str(root)]
    out = _torchrun_cli(4, argv, timeout=1800)
    print("\n".join(ln for ln in out.splitlines()
                    if ln.startswith("[train-gs]") and " record " not in ln))
    rec = record(out, "[train-gs]")
    _print_record("rayleigh_taylor CLI", rec)
    print(f"rayleigh_taylor CLI losses {rec['losses']}")
    losses = np.asarray(rec["losses"])
    assert len(losses) == steps and np.isfinite(losses).all()
    print(f"rayleigh_taylor CLI mean loss of each pass over the 16 views "
          f"{losses.reshape(-1, 16).mean(1).round(6).tolist()}")
    assert rec["world"] == 4 and rec["mesh"] == [4, 1]
    for r in rec["ranks"]:
        assert min(r["launches"]) >= steps, r
    assert np.isfinite([rec["psnr"], rec["ssim"]]).all()

    tel = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="0")
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_gs", "--ckpt-dir",
         str(root), "--views", "2", "--passes", "2", "--device", "cuda",
         "--telemetry-json", str(tel)], env=env, capture_output=True,
        text=True, timeout=600)
    print(serve.stdout)
    assert serve.returncode == 0, (serve.stdout[-3000:], serve.stderr[-4000:])
    with open(tel) as f:
        served = json.load(f)
    cold, warm = served["passes"]
    print(f"rayleigh_taylor serve_gs: restore {served['restore_s']:.3f} s, "
          f"cold {cold['req_per_s']:.3f} req/s ({cold['wall_s']:.3f} s), "
          f"warm {warm['req_per_s']:.3f} req/s, launches "
          f"{served['kernel_launches']}")
    assert warm["hits"] == warm["requests"] == 2
    assert served["kernel_launches"] > 0


#: one SMOKE arch per family: dense, moe, ssm, hybrid, encdec, vlm
LM_FAMILIES = ["minicpm-2b", "mixtral-8x22b", "mamba2-780m", "jamba-v0.1-52b",
               "whisper-tiny", "paligemma-3b"]


def _lm_trace(spec, params, dev, B=2, S=64, steps=3):
    """Prefill and ``steps`` decode steps from zero f32 caches (the prompt's
    first tokens fed) -> [(name, tensor on the host)]."""
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import decoder as dec
    from repro_torch.models import make_prefill_step, zeros_caches

    batch = make_batch(spec, B, S, torch.Generator().manual_seed(1), dev)
    logits, pcaches = make_prefill_step(spec, kv_chunk=32)(params, batch)
    out = [("prefill_logits", logits)]
    out += [(f"prefill_{s}_{n}", t) for s, c in pcaches.items() for n, t in c.items()]
    caches = zeros_caches(spec, B, 32, device=dev, dtype=torch.float32)
    with torch.inference_mode():
        for i in range(steps):
            x = dec.embed_tokens(spec, params, batch["tokens"][:, i:i + 1],
                                 torch.full((1,), i, device=dev))
            h, caches = dec.decoder_decode(spec, params, x, caches, i)
            out += [(f"step{i}_hidden", h),
                    (f"step{i}_logits", dec.lm_logits(spec, params, h))]
            out += [(f"step{i}_{s}_{n}", t.clone())
                    for s, c in caches.items() for n, t in c.items()]
    return [(k, v.float().cpu()) for k, v in out]


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_cuda_lm_prefill_and_decode_match_cpu(cuda, arch):
    """The LM serving path in float32 (TF32 off) from one ``init_params``
    state: prefill and three decode steps on the card equal the same code
    on the CPU within 1e-4 of each tensor's largest magnitude."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params

    spec = get_smoke(arch)
    host = init_params(spec, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _lm_trace(spec, to(host), cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = _lm_trace(spec, host, "cpu")
    assert [k for k, _ in got] == [k for k, _ in want]
    for (name, g), (_, w) in zip(got, want):
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err <= 1e-4, (arch, name, err)


#: flash vjp against scan on the card: two of tests/test_flash_vjp.py's
#: CASES (GQA; Skv % chunk != 0) and the training CLI's attention shape
#: (B 8, S 512, 48 heads of 64, kv_chunk 128)
FLASH_CASES = [
    # (B, Sq, Skv, Hq, Hkv, hd, causal, window, prefix, kv_chunk)
    (2, 16, 16, 4, 2, 8, True, None, 0, 8),
    (2, 8, 24, 4, 2, 16, True, None, 0, 10),
    (8, 512, 512, 48, 48, 64, True, None, 0, 128),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_vjp_matches_scan(cuda, case):
    """The recomputing flash backward (``impl="vjp"``) against autograd
    through the chunk loop (``impl="scan"``) in float32 on the card, TF32
    off: 2e-5 forward, 5e-4 on dq, dk and dv (tests/test_flash_vjp.py's)."""
    from repro_torch.models import layers

    B, Sq, Skv, Hq, Hkv, hd, causal, window, prefix, chunk = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=cuda) * 0.5
               for s in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))
    g = torch.randn((B, Sq, Hq, hd), generator=gen, device=cuda)
    kw = dict(causal=causal, window=window, prefix_len=prefix, kv_chunk=chunk)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for impl in ("vjp", "scan"):
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            out = layers.flash_attention(*ts, impl=impl, **kw)
            res[impl] = [out.detach()] + list(torch.autograd.grad(out, ts, g))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), res["vjp"], res["scan"],
                               (2e-5, 5e-4, 5e-4, 5e-4)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=f"{name} {case}")


def _lm_train_trace(spec, params, dev):
    """Two f32 train steps (B 2, S 64, kv_chunk 32, total_steps 10) from
    ``params`` (updated in place) -> [(name, tensor on the host)]: each
    step's metrics, then m, v and the parameters."""
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import TrainCfg, init_opt_state, make_train_step
    from repro_torch.runtime.checkpoint import tree_flatten

    cfg = TrainCfg(total_steps=10, kv_chunk=32)
    step, opt, out = make_train_step(spec, cfg), init_opt_state(spec, params, cfg), []
    for i in range(2):
        gen = torch.Generator().manual_seed(10 + i)
        batch = make_batch(spec, 2, 64, gen, "cpu")
        batch = {k: (v.float() if v.is_floating_point() else v) for k, v in batch.items()}
        batch["labels"] = torch.randint(0, spec.vocab, batch["tokens"].shape,
                                        generator=gen, dtype=torch.int32)
        params, opt, metrics = step(params, opt, {k: v.to(dev) for k, v in batch.items()})
        out += [(f"step{i}_{k}", v) for k, v in metrics.items()]
    for name, tree in (("m", opt["adam"]["m"]), ("v", opt["adam"]["v"]),
                       ("param", params)):
        out += [(f"{name}{j}", t) for j, t in enumerate(tree_flatten(tree)[0])]
    return [(k, v.float().cpu()) for k, v in out]


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_cuda_lm_train_steps_match_cpu(cuda, arch):
    """The LM train step in float32 (TF32 off) from one ``init_params``
    state: two steps on the card equal the same code on the CPU within 1e-4
    of each tensor's largest magnitude (loss, aux, grad norm, lr scale, m,
    v and the parameters; a parameter also within 2 * lr * lr_scale(step
    1), the most Adam moves an element whose gradient is rounding noise,
    as tests/_torch_lm.py bounds the reference comparison)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.checkpoint import tree_map

    spec = get_smoke(arch)
    host = init_params(spec, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    card = tree_map(lambda t: t.clone().to(cuda), host)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _lm_train_trace(spec, card, cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = _lm_train_trace(spec, host, "cpu")
    assert [k for k, _ in got] == [k for k, _ in want]
    slack = 2 * AdamWConfig().lr * float(dict(want)["step1_lr_scale"])
    errs = {name: (float((g - w).abs().max()) - (slack if name.startswith("param") else 0))
            / max(float(w.abs().max()), 1e-30)
            for (name, g), (_, w) in zip(got, want)}
    print(f"{arch}: largest card vs CPU error {max(errs.values()):.3e}")
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    assert not bad, (arch, bad)
