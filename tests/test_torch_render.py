"""Port parity: data, primitives, cameras, projection and the render path.

The same seeded scene goes through the JAX package and the port (the model
carried across with ``gaussians_from_numpy``).  Gates: point clouds and
cameras identical; ``from_points`` and ``project`` at 1e-6; rendered images
at 1e-5 (the rasterizer's gate).  Scenes are checked to have no projected
radius within 1e-4 of an integer before the ceil, where an ulp between two
projections could move a splat's radius by a pixel.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cameras as jc  # noqa: E402
from repro.core import gaussians as jg  # noqa: E402
from repro.core import projection as jp  # noqa: E402
from repro.core.tiling import TileGrid as JGrid  # noqa: E402
from repro.data.isosurface import point_cloud_for as j_point_cloud  # noqa: E402
from repro_torch.core import cameras as tc  # noqa: E402
from repro_torch.core import gaussians as tg  # noqa: E402
from repro_torch.core import projection as tp  # noqa: E402
from repro_torch.core.dtypes import cast_tables, check_policy  # noqa: E402
from repro_torch.core.render import (assign_tables, max_tile_count,  # noqa: E402
                                     render, render_batch,
                                     render_batch_tables, resolve_assignment)
from repro_torch.core.tiling import TileGrid  # noqa: E402
from repro_torch.data.isosurface import point_cloud_for  # noqa: E402

# the module, not the render() function ``repro.core`` re-exports
jr = importlib.import_module("repro.core.render")

RES = 32
DIMS = (RES, RES, 8, 16)
CENTER = (0.5, 0.5, 0.5)
IMG_TOL = 1e-5


def j_model(n=300, seed=0, random_pose=False):
    """A reference model from the sphere_shell point cloud; with
    ``random_pose`` the scales and rotations are randomised (seeded), so
    projection exercises anisotropic covariances."""
    pts, cols = j_point_cloud("sphere_shell", n, seed=seed)
    g = jg.from_points(jnp.asarray(pts), jnp.asarray(cols), opacity=0.9)
    if random_pose:
        r = np.random.default_rng(seed)
        q = r.normal(size=(g.capacity, 4)).astype(np.float32)
        ls = np.asarray(g.log_scales) + r.uniform(
            -0.5, 0.5, size=(g.capacity, 3)).astype(np.float32)
        g = g._replace(quats=jnp.asarray(q), log_scales=jnp.asarray(ls))
    return g


def to_port(g):
    return tg.gaussians_from_numpy({k: np.asarray(v) for k, v in
                                    g._asdict().items()}, device="cpu")


def rigs(n, radius):
    return (jc.orbital_rig(n, CENTER, radius, width=RES, height=RES),
            tc.orbital_rig(n, CENTER, radius, width=RES, height=RES,
                           device="cpu"))


def assert_radius_margin(g, cams):
    """No splat's pre-ceil radius 3*sqrt(lam1) within 1e-4 of an integer
    (recomputed from the reference's cov2d), for every view."""
    splats = jax.vmap(lambda c: jp.project(g, c),
                      in_axes=(jc.CAM_VAXES,))(cams)
    cov = np.asarray(splats.cov2d, np.float32)
    a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
    mid = np.float32(0.5) * (a + c)
    lam1 = mid + np.sqrt(np.maximum(mid * mid - (a * c - b * b), 1e-9))
    r = 3.0 * np.sqrt(np.maximum(lam1, 1e-9))
    assert np.abs(r - np.rint(r)).min() > 1e-4


@functools.lru_cache(maxsize=None)
def j_render(dims, K):
    grid = JGrid(*dims)
    return jax.jit(lambda g, c: jr.render(g, c, grid, K=K, impl="ref"))


@functools.lru_cache(maxsize=None)
def j_render_batch(dims, K):
    grid = JGrid(*dims)
    return jax.jit(lambda g, c: jr.render_batch(g, c, grid, K=K, impl="ref"))


# ---------------------------------------------------------------------------
# data, primitives, cameras
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n,t", [("sphere_shell", 500, 0.0),
                                      ("kingsnake", 3000, 0.0),
                                      ("rayleigh_taylor", 800, 0.5)])
def test_point_cloud_identical(name, n, t):
    pts, cols = point_cloud_for(name, n, seed=3, t=t)
    want_p, want_c = j_point_cloud(name, n, seed=3, t=t)
    np.testing.assert_array_equal(pts, want_p)
    np.testing.assert_array_equal(cols, want_c)


def test_from_points_and_carry_across():
    pts, cols = j_point_cloud("kingsnake", 2000, seed=1)
    for kw in (dict(opacity=0.9), dict(capacity=2100, owner_id=3),
               dict(init_scale=0.02, opacity=0.5)):
        want = jg.from_points(jnp.asarray(pts), jnp.asarray(cols), **kw)
        got = tg.from_points(pts, cols, device="cpu", **kw)
        for name in jg.Gaussians._fields:
            w = np.asarray(getattr(want, name))
            o = getattr(got, name).numpy()
            assert o.dtype == w.dtype and o.shape == w.shape, name
            np.testing.assert_allclose(o, w, rtol=1e-6, atol=1e-6)
    grey = tg.from_points(pts, device="cpu")
    np.testing.assert_allclose(
        grey.colors.numpy(),
        np.asarray(jg.from_points(jnp.asarray(pts)).colors), atol=0)
    # the numpy carry-across is exact both ways
    g = j_model(random_pose=True)
    d = {k: np.asarray(v) for k, v in g._asdict().items()}
    back = tg.gaussians_to_numpy(tg.gaussians_from_numpy(d, device="cpu"))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
        assert back[k].dtype == d[k].dtype


def test_rotations_and_covariance():
    r = np.random.default_rng(2)
    q = r.normal(size=(50, 4)).astype(np.float32)
    ls = r.uniform(-3, 0, size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tg.quat_to_rotmat(torch.from_numpy(q)).numpy(),
        np.asarray(jg.quat_to_rotmat(jnp.asarray(q))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tg.covariance3d(torch.from_numpy(ls), torch.from_numpy(q)).numpy(),
        np.asarray(jg.covariance3d(jnp.asarray(ls), jnp.asarray(q))),
        rtol=1e-6, atol=1e-7)


def test_cameras_identical():
    jrig, trig = rigs(7, 2.5)
    np.testing.assert_array_equal(trig.view.numpy(), np.asarray(jrig.view))
    np.testing.assert_array_equal(trig.fx.numpy(), np.asarray(jrig.fx))
    np.testing.assert_array_equal(trig.fy.numpy(), np.asarray(jrig.fy))
    np.testing.assert_array_equal(tc.look_at((0, 0, 3), CENTER),
                                  jc.look_at((0, 0, 3), CENTER))
    one, jone = tc.select(trig, 4), jc.select(jrig, 4)
    np.testing.assert_array_equal(one.view.numpy(), np.asarray(jone.view))
    assert (one.cx, one.cy) == (jone.cx, jone.cy)
    two = tc.select(trig, torch.tensor([1, 5]))
    assert tuple(two.view.shape) == (2, 4, 4) and tuple(two.fx.shape) == (2,)
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else ValueError):
        tc.orbital_rig(2, CENTER, 1.0, width=8, height=8,
                       device="cuda" if not torch.cuda.is_available()
                       else "bogus")


@pytest.mark.parametrize("radius", [1.5, 0.2])
def test_project_matches(radius):
    """Single and view-batched projection at 1e-6 of each field's
    magnitude; 0.2 puts the camera inside the shell, so splats behind it
    are culled.  (The reference's CPU dots contract each multiply-add into
    one fused operation, the port's matmuls round every product: one
    rounding apart, which the cancelling off-diagonal of cov2d amplifies
    to ~1e-5 relative to that entry, ~1e-7 of the field.)"""
    g = j_model(random_pose=True)
    jrig, trig = rigs(3, radius)
    gt = to_port(g)
    batched = tp.project(gt, trig)
    for v in range(3):
        want = jp.project(g, jc.select(jrig, v))
        got = tp.project(gt, tc.select(trig, v))
        for name in jp.Splats2D._fields:
            w = np.asarray(getattr(want, name))
            for o in (getattr(got, name), getattr(batched, name)[v]):
                o = o.numpy()
                assert o.shape == w.shape, name
                if o.dtype == np.bool_:
                    np.testing.assert_array_equal(o, w, err_msg=name)
                else:
                    scale = max(1.0, float(np.abs(w).max()))
                    np.testing.assert_allclose(o, w, rtol=1e-6,
                                               atol=1e-6 * scale,
                                               err_msg=name)
    if radius < 1.0:
        assert not np.asarray(jp.project(g, jc.select(jrig, 0)).valid).all()


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------


def test_render_matches_reference():
    g = j_model()
    jrig, trig = rigs(3, 1.5)
    assert_radius_margin(g, jrig)
    gt = to_port(g)
    tgrid = TileGrid(*DIMS)
    for v in range(3):
        want = j_render(DIMS, 16)(g, jc.select(jrig, v))
        got = render(gt, tc.select(trig, v), tgrid, K=16)
        np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                                   rtol=IMG_TOL, atol=IMG_TOL)
        np.testing.assert_allclose(got.coverage.numpy(),
                                   np.asarray(want.coverage),
                                   rtol=IMG_TOL, atol=IMG_TOL)
        assert int(got.assign_overflow) == int(want.assign_overflow) == 0
        assert got.overflow is None
    # a bf16 dtype policy still composites in f32
    b16 = render(gt, tc.select(trig, 0), tgrid, K=16, dtype_policy="bf16")
    assert b16.rgb.dtype == torch.float32
    with pytest.raises(ValueError):
        check_policy("fp8")
    x = torch.ones(2)
    assert cast_tables(x, "f32") is x
    cast = cast_tables({"a": x, "b": (x, torch.ones(2, dtype=torch.int32))},
                       "bf16")
    assert cast["a"].dtype == torch.bfloat16
    assert cast["b"][1].dtype == torch.int32


def test_render_batch_and_tables_match_reference():
    g = j_model(seed=1)
    jrig, trig = rigs(4, 1.5)
    assert_radius_margin(g, jrig)
    gt = to_port(g)
    want = j_render_batch(DIMS, 16)(g, jrig)
    tgrid = TileGrid(*DIMS)
    got = render_batch(gt, trig, tgrid, K=16)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                               rtol=IMG_TOL, atol=IMG_TOL)
    np.testing.assert_allclose(got.coverage.numpy(),
                               np.asarray(want.coverage),
                               rtol=IMG_TOL, atol=IMG_TOL)
    np.testing.assert_array_equal(got.assign_overflow.numpy(),
                                  np.asarray(want.assign_overflow))
    # render from the reference's own tables
    idx, score, _ = jr.assign_tables_jit(JGrid(*DIMS), 16)(g, jrig)
    tables = render_batch_tables(gt, trig, tgrid,
                                 torch.from_numpy(np.array(idx)),
                                 torch.from_numpy(np.array(score)))
    want_t = jr.render_tables_jit(JGrid(*DIMS), "ref", 1.0)(g, jrig, idx,
                                                           score)
    np.testing.assert_allclose(tables.rgb.numpy(), np.asarray(want_t.rgb),
                               rtol=IMG_TOL, atol=IMG_TOL)
    np.testing.assert_allclose(tables.rgb.numpy(), got.rgb.numpy(),
                               rtol=IMG_TOL, atol=IMG_TOL)


def test_assign_tables_and_budget_probe():
    """Table extraction on a 64-tile grid with splats larger than the
    traced default budget: the port's tables (indices exactly, scores at
    1e-6: two projections) and overflow counts match the jitted
    reference, and the host probe resolves the same (impl, budget)."""
    g = j_model(seed=2)
    dims = (64, 64, 8, 8)
    cams = jc.orbital_rig(3, CENTER, 1.2, width=64, height=64)
    tcams = tc.orbital_rig(3, CENTER, 1.2, width=64, height=64, device="cpu")
    assert_radius_margin(g, cams)
    gt = to_port(g)
    for impl in ("dense", "sorted"):
        want = jr.assign_tables_jit(JGrid(*dims), 8, None, impl)(g, cams)
        got = assign_tables(gt, tcams, TileGrid(*dims), 8, assign_impl=impl)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(np.asarray(want[2]).sum()) > 0      # traced budget 16 starves
    assert max_tile_count(gt, tcams, TileGrid(*dims), chunk=2) == \
        jr.max_tile_count(g, cams, JGrid(*dims), chunk=2)
    for kw in (dict(), dict(assign_impl="sorted"),
               dict(assign_impl="sorted", assign_budget=7),
               dict(assign_impl="dense")):
        for d in (dims, (512, 512, 16, 16)):
            assert resolve_assignment(gt, tcams, TileGrid(*d), **kw) == \
                jr.resolve_assignment(g, cams, JGrid(*d), **kw)
