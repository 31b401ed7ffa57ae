"""The CUDA projection pair on the card, against the plain PyTorch version.

``project_fwd`` / ``project_bwd`` (kernels/project.py) have no CPU mode, so
every case here carries the ``cuda`` marker and skips with a reason where
there is no card.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_project_cuda.py

Gates.  Forward: every float field at 1e-6 of its magnitude against
``project_ref`` on the same card (the kernel writes the plain version's
GEMMs as cuBLAS's fused multiply-add chains; the quaternion's norm is a
reduction of another order); radius and valid exactly.  The scenes
keep every pre-ceil radius, and every edge of the radius box against the
image, at least 1e-4 (ROADMAP's "Rounding" note) or 1e-6 of its
magnitude, the larger, from the value that flips it (a splat at the near
plane has a radius of thousands of pixels, whose rounding exceeds 1e-4),
so one rounding cannot move them.  Backward: each gradient at
``GRAD_RTOL`` of the element and ``GRAD_ATOL`` of the field's largest
against autograd of the plain version: both run in float32, but autograd
sums the views and the matrix products' terms in other orders, and the
quaternion's gradient cancels (the normalisation removes its radial part),
so one rounding shows at ~1e-7 of the field's largest; a splat just past
the near plane has a mean gradient of ~1e8 (1 / z^2), summed over views
whose terms cancel, which the card showed 1.1e-5 apart.  The
near-degenerate quaternions' rows are held apart, at their own largest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import projection as tp  # noqa: E402
from repro_torch.core.cameras import orbital_rig, select  # noqa: E402
from repro_torch.core.gaussians import Gaussians  # noqa: E402
from repro_torch.kernels import project as pk  # noqa: E402

pytestmark = pytest.mark.cuda

FIELD_TOL = 1e-6
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
MARGIN = 1e-4
REL_MARGIN = 1e-6
TRAINED = ("means", "log_scales", "quats")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _scene(seed, n):
    """n splats around (0.5, 0.5, 0.5), as numpy: anisotropic scales and
    random rotations, with inactive splats, splats under alpha_min,
    near-degenerate quaternions (|q| ~ 1e-7, and exactly 0) and scales
    (exp(-12), and one axis 1e5 times the others)."""
    r = np.random.default_rng(seed)
    f = {
        "means": r.uniform(-0.6, 1.6, (n, 3)),
        "log_scales": np.log(r.uniform(0.002, 0.08, (n, 3))),
        "quats": r.normal(size=(n, 4)),
        "opacity_logit": r.normal(0.0, 2.0, n),
        "colors": r.normal(size=(n, 3)),
        "active": r.uniform(size=n) > 0.1,
        "owner": np.zeros(n, np.int32),
    }
    k = r.permutation(n)[: n // 5]
    f["opacity_logit"][k[: n // 20]] = -8.0              # alpha < 1/255
    f["quats"][k[n // 20: n // 10]] *= 1e-7
    f["quats"][k[n // 10]] = 0.0
    f["log_scales"][k[n // 10 + 1: 3 * n // 20]] = -12.0
    f["log_scales"][k[3 * n // 20:], 0] -= np.log(1e5)
    return {name: a.astype(np.float32) if a.dtype == np.float64 else a
            for name, a in f.items()}


def _gaussians(f, dev):
    return Gaussians(**{k: torch.from_numpy(v).to(dev) for k, v in f.items()})


def _rig(V, dev):
    """V views from inside the cloud's box (radius 0.9 around its centre):
    some splats lie behind the near plane, some off screen."""
    return orbital_rig(V, (0.5, 0.5, 0.5), 0.9, width=96, height=64,
                       device=dev)


def _margin(x):
    """MARGIN, or REL_MARGIN of x where that is larger: a value of
    thousands of pixels carries a rounding of ~1e-7 of itself."""
    return torch.clamp(REL_MARGIN * x.abs(), min=MARGIN)


def _margin_rows(s, cam, near=0.05):
    """Splats (N,) whose every view keeps the pre-ceil radius, the radius
    box's edges and z at least ``_margin`` from the values that flip radius
    or valid (from the plain version's fields)."""
    a, b, c = s.cov2d.unbind(-1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - (a * c - b * b),
                                        min=1e-9))
    pre = 3.0 * torch.sqrt(torch.clamp(lam1, min=1e-9))
    u, v = s.mean2d.unbind(-1)
    edges = torch.stack([u + s.radius, u - s.radius - cam.width,
                         v + s.radius, v - s.radius - cam.height], -1)
    pixels = torch.maximum(u.abs(), v.abs())
    ok = ((pre - torch.round(pre)).abs() > _margin(pre)) \
        & (edges.abs() > _margin(pixels)[..., None]).all(-1) \
        & ((s.depth - near).abs() > MARGIN)
    return ok.reshape(-1, ok.shape[-1]).all(0)


def _held_scene(seed, n, V, dev):
    """The scene cut to the splats that keep the margins in all V views."""
    f = _scene(seed, n)
    cam = _rig(V, dev)
    with torch.no_grad():
        keep = _margin_rows(tp.project_ref(_gaussians(f, dev), cam), cam)
    keep = keep.cpu().numpy()
    assert keep.mean() > 0.9
    return {k: np.ascontiguousarray(v[keep]) for k, v in f.items()}, cam


def _cam_of(cam, V):
    return cam if V > 1 else select(cam, 0)


@pytest.mark.parametrize("V", [1, 8])
def test_project_fwd_matches_plain_version(cuda, V):
    f, rig = _held_scene(V, 20000, V, cuda)
    g, cam = _gaussians(f, cuda), _cam_of(rig, V)
    before = pk.PROJECT_LAUNCHES
    got = tp.project(g, cam)
    assert pk.PROJECT_LAUNCHES == before + 1
    want = tp.project_ref(g, cam)
    valid = want.valid.cpu().numpy()
    # every case the scene was built for is there
    assert valid.any() and not valid.all()
    assert (want.depth < 0.05).any()
    for name in tp.Splats2D._fields:
        o = getattr(got, name).cpu().numpy()
        w = getattr(want, name).cpu().numpy()
        assert o.shape == w.shape, name
        if name in ("radius", "valid"):
            np.testing.assert_array_equal(o, w, err_msg=name)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(o, w, rtol=FIELD_TOL,
                                       atol=FIELD_TOL * scale, err_msg=name)


def _grads(g, cam, cot, fn):
    tr = {k: getattr(g, k).clone().requires_grad_(True) for k in TRAINED}
    s = fn(g._replace(**tr), cam)
    loss = ((s.mean2d * cot[0]).sum() + (s.cov2d * cot[1]).sum()
            + (s.depth * cot[2]).sum())
    loss.backward()
    return [tr[k].grad for k in TRAINED]


@pytest.mark.parametrize("V", [1, 8])
def test_project_bwd_matches_autograd_of_plain_version(cuda, V):
    f, rig = _held_scene(10 + V, 20000, V, cuda)
    g, cam = _gaussians(f, cuda), _cam_of(rig, V)
    n = g.means.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(V)
    lead = (V, n) if V > 1 else (n,)
    cot = [torch.randn(lead + tail, generator=gen, device=cuda)
           for tail in ((2,), (3,), ())]
    fwd, bwd = pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES
    got = _grads(g, cam, cot, tp.project)
    assert (pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES) == (fwd + 1,
                                                              bwd + 1)
    again = _grads(g, cam, cot, tp.project)
    want = _grads(g, cam, cot, tp.project_ref)
    # the near-degenerate quaternions' gradients are ~1e7 (|q| ~ 1e-7) and
    # 1e12 (q = 0, under the clamp) times the others: each group is held at
    # its own largest
    norm = np.linalg.norm(f["quats"], axis=-1)
    groups = [norm == 0, (norm > 0) & (norm < 1e-3), norm >= 1e-3]
    assert groups[1].any() and groups[2].any()
    for name, o, a, w in zip(TRAINED, got, again, want):
        assert torch.equal(o, a), name              # no atomics
        o, w = o.cpu().numpy(), w.cpu().numpy()
        for rows in groups:
            if rows.any():
                np.testing.assert_allclose(
                    o[rows], w[rows], rtol=GRAD_RTOL,
                    atol=GRAD_ATOL * float(np.abs(w[rows]).max()),
                    err_msg=name)


def test_project_fwd_refuses_bad_inputs(cuda):
    f, rig = _held_scene(3, 256, 2, cuda)
    g = _gaussians(f, cuda)
    with pytest.raises(ValueError):                 # not contiguous
        pk.project_fwd(g.means.t().contiguous().t(), g.log_scales, g.quats,
                       torch.sigmoid(g.opacity_logit), g.active, rig.view,
                       rig.fx, rig.fy, width=96, height=64, near=0.05,
                       alpha_min=1 / 255)
    with pytest.raises(ValueError):                 # another device
        pk.project_fwd(g.means.cpu(), g.log_scales, g.quats,
                       torch.sigmoid(g.opacity_logit), g.active, rig.view,
                       rig.fx, rig.fy, width=96, height=64, near=0.05,
                       alpha_min=1 / 255)


def _tiny(dev):
    """A 128-splat sphere-shell model with free slots and a 2-view 32x32
    rig."""
    from repro_torch.core.gaussians import from_points
    from repro_torch.data.isosurface import point_cloud_for

    pts, cols = point_cloud_for("sphere_shell", 128)
    g = from_points(pts[:128], cols[:128], capacity=192, opacity=0.7,
                    device=dev)
    cams = orbital_rig(2, (0.5, 0.5, 0.5), 1.6, width=32, height=32,
                       device=dev)
    return g, cams


def test_render_batch_launches_each_kernel_once(cuda):
    from repro_torch.core.render import render_batch
    from repro_torch.core.tiling import TileGrid

    g, cams = _tiny(cuda)
    tr = {k: p.clone().requires_grad_(True) for k, p in g.trainable().items()}
    fwd, bwd = pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES
    out = render_batch(g.with_trainable(tr), cams, TileGrid(32, 32, 8, 16),
                       K=8)
    assert (pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES) == (fwd + 1, bwd)
    out.rgb.sum().backward()
    assert (pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES) == (fwd + 1,
                                                              bwd + 1)
    assert tr["means"].grad.abs().max().item() > 0


def test_train_step_launches_each_kernel_once(cuda):
    """One step of ``make_gs_train_step`` on a world of one (NCCL): the
    shard's two partitions go through one projection launch each way."""
    from repro_torch.core import distributed as D
    from repro_torch.core.cameras import Camera
    from repro_torch.core.tiling import TileGrid
    from repro_torch.core.train import GSTrainCfg, init_opt
    from repro_torch.launch import mesh as mesh_mod

    g, cams = _tiny(cuda)
    g2 = Gaussians(*(torch.stack([f, f]) for f in g))
    grid = TileGrid(32, 32, 8, 16)
    gts = torch.full((2, 2, 32, 32, 3), 0.5, device=cuda)
    gt_t, mask_t = D._tile_view_batches(gts, None, grid)
    batch = {"gt_tiles": gt_t[:1], "mask_tiles": mask_t[:1],
             "cam": Camera(cams.view[:1], cams.fx[:1], cams.fy[:1],
                           cams.width, cams.height)}
    mesh_mod.init_distributed(cuda, timeout_s=60)
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("part", "view"))
        step = D.make_gs_train_step(
            mesh, GSTrainCfg(K=8, tile_h=8, tile_w=16), grid, 1.0, views=1,
            k_tiers=None)
        gl, ol = D.gs_shard_state((g2, init_opt(g2)), mesh)
        fwd, bwd = pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES
        _, _, loss = step(gl, ol, D.gs_shard_batch(batch, mesh, 1))
        assert np.isfinite(float(loss))
        assert (pk.PROJECT_LAUNCHES - fwd, pk.PROJECT_BWD_LAUNCHES - bwd) \
            == (1, 1)
    finally:
        mesh_mod.destroy_distributed()
