"""The plain reference on scenes small enough to check by hand, and
against the program's own functions at a small size."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from gsbench import reference as R  # noqa: E402

F32 = R.Precision("f32")


def _splats(means, scale, opacity, colors):
    n = len(means)
    pts = torch.tensor(means, dtype=torch.float32)
    s = R.init_splats(pts, torch.tensor(colors, dtype=torch.float32), n,
                      opacity)
    s["log_scales"] = torch.full((n, 3), float(np.log(scale)))
    return s


def _camera():
    view = torch.from_numpy(R.look_at([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
                            .astype(np.float32))
    return view, 32.0


def test_projection_of_a_centred_splat():
    s = _splats([[0.0, 0.0, 0.0]], 0.05, 0.5, [[0.5, 0.5, 0.5]])
    view, f = _camera()
    pr = R.project(s, view, f, 32, 32, F32)
    u, v, a, b, c = pr["feat"][0, :5].tolist()
    assert (u, v) == pytest.approx((16.0, 16.0))
    # sigma_px = f * 0.05 / 2 = 0.8, variance 0.64 + 0.3 dilation
    assert 1 / a == pytest.approx(0.94, rel=1e-5) and c == pytest.approx(a)
    assert b == pytest.approx(0.0, abs=1e-7)
    assert float(pr["radius"][0]) == np.ceil(3 * np.sqrt(0.94))
    assert float(pr["depth"][0]) == pytest.approx(2.0)
    assert bool(pr["valid"][0])


def test_culling():
    s = _splats([[0.0, 0.0, -2.5], [40.0, 0.0, 0.0]], 0.05, 0.5,
                [[0.5] * 3] * 2)
    view, f = _camera()
    assert not R.project(s, view, f, 32, 32, F32)["valid"].any()


def test_tables_keep_the_front_most_k_in_depth_order():
    u = torch.tensor([8.0, 8.0, 8.0, 40.0])
    v = torch.tensor([4.0, 4.0, 4.0, 4.0])
    radius = torch.tensor([3.0, 3.0, 3.0, 3.0])
    depth = torch.tensor([3.0, 1.0, 2.0, 1.0])
    valid = torch.tensor([True, True, True, True])
    idx, live = R.tile_tables(u, v, radius, depth, valid, width=64,
                              height=8, tile_h=8, tile_w=16, K=2)
    assert idx[0].tolist() == [1, 2] and live[0].all()
    assert live[1].sum() == 0
    assert idx[2].tolist()[0] == 3 and live[2].tolist() == [True, False]


def test_compositing_front_to_back():
    # two opaque-ish splats at the first pixel: the front one dominates
    f = torch.zeros(1, 2, 9)
    f[0, :, 0:2] = 0.5                       # centred on pixel (0, 0)
    f[0, :, 2] = f[0, :, 4] = 1.0
    f[0, 0, 5:8] = torch.tensor([1.0, 0.0, 0.0])
    f[0, 1, 5:8] = torch.tensor([0.0, 1.0, 0.0])
    f[0, :, 8] = 0.5
    out = R.composite(f, width=2, height=1, tile_h=1, tile_w=2)
    r, g, b, cov = out[0, :, 0, 0].tolist()
    assert (r, g, b) == pytest.approx((0.5, 0.25, 0.0))
    assert cov == pytest.approx(0.75)
    f[0, 1, 8] = 0.003                       # under 1/255: skipped
    assert R.composite(f, width=2, height=1, tile_h=1,
                       tile_w=2)[0, 1, 0, 0] == 0.0


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0])
    assert R.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 3.0]


def test_against_the_program_small():
    from repro_torch.core.cameras import Camera
    from repro_torch.core.gaussians import from_points
    from repro_torch.core.render import render
    from repro_torch.core.tiling import TileGrid
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand((400, 3), generator=gen)
    cols = torch.rand((400, 3), generator=gen)
    view = torch.from_numpy(R.look_at([0.5, -1.5, 0.9], [0.5, 0.5, 0.5])
                            .astype(np.float32))
    f = R.focal_for(48)
    g = from_points(pts, cols, opacity=0.9, device="cpu")
    cam = Camera(view, torch.tensor(f), torch.tensor(f), 48, 40)
    prog = render(g, cam, TileGrid(48, 40, 8, 16), K=16, bg=1.0)
    s = R.init_splats(pts, cols, 400, 0.9)
    rgb, cov = R.render_image(s, view, f, width=48, height=40, tile_h=8,
                              tile_w=16, K=16, bg=1.0, prec=F32)
    assert float((prog.rgb - rgb).abs().max()) < 1e-5
    assert float((prog.coverage - cov).abs().max()) < 1e-5


def test_train_steps_continue_an_adam_run():
    # two steps in one go == one step, then one more from its state: the
    # output check's step after the window starts from the program's moments
    gen = torch.Generator().manual_seed(1)
    pts = torch.rand((200, 3), generator=gen)
    cols = torch.rand((200, 3), generator=gen)
    views = [torch.from_numpy(R.look_at(eye, [0.5, 0.5, 0.5])
                              .astype(np.float32))
             for eye in ([0.5, -1.5, 0.9], [1.9, 0.4, 0.8])]
    f = R.focal_for(32)
    shape = dict(width=32, height=32, tile_h=8, tile_w=16, K=16)
    gt_s = R.init_splats(pts, cols, 200, 0.95)
    gts, masks = [], []
    for view in views:
        rgb, cov = R.render_image(gt_s, view, f, bg=0.0, prec=F32, **shape)
        gts.append(rgb[None])
        masks.append(R.coverage_mask(cov, F32)[None])
    init = R.init_splats(pts + 0.01, cols * 0.5, 220, 0.6)
    both, _, p2 = R.train_steps([init], views, f, gts, masks, steps=2,
                                extent=1.0, prec=F32, **shape)
    one, g1, p1 = R.train_steps([init], views[:1], f, gts[:1], masks[:1],
                                steps=1, extent=1.0, prec=F32, **shape)
    m = {k: (1 - 0.9) * g for k, g in g1.items()}
    v = {k: (1 - 0.999) * g * g for k, g in g1.items()}
    start = [{**{k: p1[k][0] for k in R.FIELDS}, "active": init["active"]}]
    more, _, p = R.train_steps(start, views[1:], f, gts[1:], masks[1:],
                               steps=1, extent=1.0, prec=F32, opt=(m, v, 1),
                               **shape)
    assert one == both[:1] and more == pytest.approx(both[1:], rel=1e-6)
    for k in R.FIELDS:
        assert torch.allclose(p[k], p2[k], rtol=1e-6, atol=1e-7), k
