"""Port parity: the coarse superblock pre-cull (``assign_tiles(coarse=)``)
and ``extract_isosurface``.

Assignment is compared on the reference's own ``Splats2D`` handed to both
packages, so both sides see bit-identical inputs: ``superblock_bounds``,
``coarse_candidates``' ``(cand, overflow)`` (a saturated budget included)
and ``_coarse_budget`` bit for bit, ``assign_tiles(coarse=)`` bit for bit
on live slots against the reference and against the port's dense sweep
(oracles ``tests/test_tiling_properties.py:105`` and ``:124``).  Renders
and the train step through the pre-cull are held at the gates of the
paths they take: ``render_batch(coarse=2)`` at 1e-5
(``tests/test_batched_render.py:50``), one step's loss at 1e-6 and its
gradients at 1e-4 of each field's largest (``tests/test_torch_train.py``).
``extract_isosurface``: count equal and points within 1e-7
(``tests/test_data.py:25``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cameras as jc  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro.core.render import render_batch as j_render_batch  # noqa: E402
from repro.core import tiling as jt  # noqa: E402
from repro.core import train as jtr  # noqa: E402
from repro.core.gaussians import from_points as j_from_points  # noqa: E402
from repro.core.projection import Splats2D as JSplats  # noqa: E402
from repro.data.isosurface import extract_isosurface as j_extract  # noqa
from repro.data.isosurface import point_cloud_for as j_point_cloud  # noqa: E402
from repro.data.volumes import make_volume  # noqa: E402
from repro_torch.core import cameras as tc  # noqa: E402
from repro_torch.core import pipeline as tpl  # noqa: E402
from repro_torch.core.render import occupancy_probe  # noqa: E402
from repro_torch.core.render import render_batch  # noqa: E402
from repro_torch.core import tiling as tt  # noqa: E402
from repro_torch.core import train as ttr  # noqa: E402
from repro_torch.core.gaussians import gaussians_from_numpy  # noqa: E402
from repro_torch.core.projection import Splats2D  # noqa: E402
from repro_torch.data import isosurface as tiso  # noqa: E402

NEG = -1e30
IMG_TOL = 1e-5
FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")


def random_splats(seed, n, w, h, *, rmax=9.0, invalid_frac=0.1):
    """The reference oracle's scene (``tests/test_tiling_properties.py``):
    uniform means with a 12-pixel margin, radii up to ``rmax``."""
    r = np.random.default_rng(seed)
    return JSplats(
        mean2d=jnp.asarray(r.uniform([-12, -12], [w + 12, h + 12], (n, 2)),
                           jnp.float32),
        cov2d=jnp.ones((n, 3), jnp.float32),
        depth=jnp.asarray(r.uniform(0.1, 10.0, n), jnp.float32),
        rgb=jnp.asarray(r.uniform(0, 1, (n, 3)), jnp.float32),
        alpha=jnp.asarray(r.uniform(0.1, 0.9, n), jnp.float32),
        radius=jnp.asarray(r.uniform(0.5, rmax, n), jnp.float32),
        valid=jnp.asarray(r.uniform(size=n) > invalid_frac),
    )


def to_port_splats(s):
    return Splats2D(*(torch.from_numpy(np.array(f)) for f in s))


def to_port(g):
    return gaussians_from_numpy({k: np.asarray(v) for k, v in
                                 g._asdict().items()}, device="cpu")


def grids(res):
    return jt.TileGrid(res, res, 8, 16), tt.TileGrid(res, res, 8, 16)


@pytest.mark.parametrize("res,tile,sb", [(64, (8, 16), 2), (128, (8, 16), 4),
                                         (100, (16, 16), 3), (32, (8, 8), 8)])
def test_superblock_bounds_match(res, tile, sb):
    jgrid = jt.TileGrid(res, res, *tile)
    tgrid = tt.TileGrid(res, res, *tile)
    jlo, jhi = jt.superblock_bounds(jgrid, sb)
    tlo, thi = tt.superblock_bounds(tgrid, sb, "cpu")
    assert tlo.dtype == thi.dtype == torch.float32
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("seed,n,res,sb,budget", [
    (5, 200, 64, 2, 200), (6, 500, 64, 2, 128), (7, 350, 128, 4, 350),
    (9, 2000, 256, 4, 128)])
@pytest.mark.parametrize("block", [4096, 37])
def test_coarse_candidates_bit_equal(seed, n, res, sb, budget, block):
    """``(cand, overflow)`` bit for bit, whatever the port's block size
    (the reference scans blocks of 4096)."""
    jgrid, tgrid = grids(res)
    js = random_splats(seed, n, res, res, rmax=6.0)
    ts = to_port_splats(js)
    jcand, jov = jt.coarse_candidates(js.mean2d, js.radius, js.valid, jgrid,
                                      sb=sb, budget=budget)
    tcand, tov = tt.coarse_candidates(ts.mean2d, ts.radius, ts.valid, tgrid,
                                      sb=sb, budget=budget, block=block)
    assert tcand.dtype == torch.int32 and tov.dtype == torch.int32
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
    assert int(tov) == int(jov)


def test_coarse_overflow_counter_fires_on_saturated_budget():
    """The reference's saturated-budget oracle: a budget of half the largest
    occupancy drops exactly the (superblock, splat) pairs past it, in both
    packages."""
    jgrid, tgrid = grids(64)
    js = random_splats(8, 400, 64, 64, rmax=6.0, invalid_frac=0.0)
    ts = to_port_splats(js)
    cand_full, ov_full = tt.coarse_candidates(
        ts.mean2d, ts.radius, ts.valid, tgrid, sb=2, budget=400)
    assert int(ov_full) == 0
    occ = (cand_full.numpy() < 400).sum(axis=1)
    budget = max(int(occ.max()) // 2, 1)
    jcand, jov = jt.coarse_candidates(js.mean2d, js.radius, js.valid, jgrid,
                                      sb=2, budget=budget)
    tcand, tov = tt.coarse_candidates(ts.mean2d, ts.radius, ts.valid, tgrid,
                                      sb=2, budget=budget)
    want = np.maximum(occ - budget, 0).sum()
    assert int(tov) == int(jov) == want > 0
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))


def test_coarse_budget_matches():
    for N in (0, 5, 127, 128, 129, 1000, 40_000, 2_881_166):
        for S in (1, 4, 7, 8, 64, 256):
            for K in (8, 16, 64, 200):
                for budget in (None, 1, 100, 128, 300, 10**7):
                    assert tt._coarse_budget(N, S, K, budget) == \
                        jt._coarse_budget(N, S, K, budget), (N, S, K, budget)


@pytest.mark.parametrize("seed,n,res,sb", [
    (5, 200, 64, 2), (6, 500, 64, 2), (7, 350, 128, 4), (9, 2000, 256, 4)])
@pytest.mark.parametrize("budget", ["n", None, 128])
def test_assign_tiles_coarse_matches(seed, n, res, sb, budget):
    """Against the reference: scores and overflow bit for bit, indices on
    live slots (``budget`` "n": exact; None: the auto budget, which
    overflows on the 2000-splat scene; 128: starved).  Against the port's
    dense sweep, bit for bit on live slots whenever the counter is 0."""
    budget = n if budget == "n" else budget
    jgrid, tgrid = grids(res)
    js = random_splats(seed, n, res, res, rmax=6.0)
    ts = to_port_splats(js)
    ji, jsc, jov = jt.assign_tiles(js, jgrid, K=24, coarse=sb,
                                   coarse_budget=budget, return_overflow=True)
    ti, tsc, tov = tt.assign_tiles(ts, tgrid, K=24, coarse=sb,
                                   coarse_budget=budget, return_overflow=True)
    assert int(tov) == int(jov)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    live = np.asarray(jsc) > NEG / 2
    np.testing.assert_array_equal(ti.numpy()[live], np.asarray(ji)[live])
    assert (ti.numpy()[~live] == 0).all()
    if int(tov) == 0:
        di, dsc = tt.assign_tiles(ts, tgrid, K=24)
        np.testing.assert_array_equal(tsc.numpy(), dsc.numpy())
        np.testing.assert_array_equal(ti.numpy()[live], di.numpy()[live])


def test_assign_tiles_coarse_edges():
    """A budget at N runs the dense sweep itself; so does a grid of fewer
    than 8 superblocks under the auto budget; "sorted" ignores coarse."""
    jgrid, tgrid = grids(64)
    js = random_splats(3, 300, 64, 64)
    ts = to_port_splats(js)
    dense = tt.assign_tiles(ts, tgrid, K=16)
    for kw in (dict(coarse=2, coarse_budget=300), dict(coarse=4),
               dict(coarse=1)):
        got = tt.assign_tiles(ts, tgrid, K=16, **kw)
        for a, b in zip(got, dense):
            assert torch.equal(a, b), kw
    sorted_ = tt.assign_tiles(ts, tgrid, K=16, impl="sorted", tile_budget=64)
    coarse_sorted = tt.assign_tiles(ts, tgrid, K=16, impl="sorted",
                                    tile_budget=64, coarse=2,
                                    coarse_budget=128)
    for a, b in zip(coarse_sorted, sorted_):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def scene(n=600, res=48, n_views=5, seed=0):
    """The reference oracle's render scene (``tests/test_batched_render.py``)
    in both packages."""
    pts, cols = j_point_cloud("sphere_shell", n, seed=seed)
    g = j_from_points(jnp.asarray(pts), jnp.asarray(cols), opacity=0.9)
    cams = jc.orbital_rig(n_views, (0.5, 0.5, 0.5), 1.5, width=res,
                          height=res)
    tcams = tc.orbital_rig(n_views, (0.5, 0.5, 0.5), 1.5, width=res,
                           height=res, device="cpu")
    return g, cams, tcams, res


@pytest.mark.parametrize("coarse_budget", [None, 64])
def test_render_batch_coarse_matches_reference(coarse_budget):
    """``render_batch(coarse=2)`` against the reference's at 1e-5, its
    ``assign_overflow`` equal, and against the port's dense render at the
    reference oracle's 1e-6 when nothing overflowed."""
    g, cams, tcams, res = scene()
    jgrid, tgrid = grids(res)
    jout = j_render_batch(g, cams, jgrid, K=16, impl="ref", coarse=2,
                          coarse_budget=coarse_budget)
    with torch.no_grad():
        tout = render_batch(to_port(g), tcams, tgrid, K=16, impl="ref",
                            coarse=2, coarse_budget=coarse_budget)
        dense = render_batch(to_port(g), tcams, tgrid, K=16, impl="ref")
    np.testing.assert_allclose(tout.rgb.numpy(), np.asarray(jout.rgb),
                               rtol=IMG_TOL, atol=IMG_TOL)
    np.testing.assert_allclose(tout.coverage.numpy(),
                               np.asarray(jout.coverage), rtol=IMG_TOL,
                               atol=IMG_TOL)
    np.testing.assert_array_equal(tout.assign_overflow.numpy(),
                                  np.asarray(jout.assign_overflow))
    if coarse_budget is None:
        assert int(tout.assign_overflow.sum()) == 0
        np.testing.assert_allclose(tout.rgb.numpy(), dense.rgb.numpy(),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert int(tout.assign_overflow.sum()) > 0


def test_render_views_and_probe_take_coarse():
    """``render_views(coarse=)`` (tiered, its occupancy probe included)
    equals the reference's, and the port's dense ``render_views`` while the
    pre-cull drops nothing."""
    g, cams, tcams, res = scene()
    jgrid, tgrid = grids(res)
    jrgb, jcov = jpl.render_views(g, cams, jgrid, K=16, impl="ref",
                                  coarse=2, k_tiers=(4, 16), batch=2)
    trgb, tcov = tpl.render_views(to_port(g), tcams, tgrid, K=16, impl="ref",
                                  coarse=2, k_tiers=(4, 16), batch=2)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=IMG_TOL,
                               atol=IMG_TOL)
    drgb, _ = tpl.render_views(to_port(g), tcams, tgrid, K=16, impl="ref",
                               k_tiers=(4, 16), batch=2)
    np.testing.assert_allclose(trgb.numpy(), drgb.numpy(), rtol=1e-6,
                               atol=1e-6)
    occ_c = occupancy_probe(to_port(g), tcams, tgrid, K=16, coarse=2)
    occ_d = occupancy_probe(to_port(g), tcams, tgrid, K=16)
    assert torch.equal(occ_c, occ_d)


def test_train_step_coarse_loss_and_gradients():
    """``GSTrainCfg(coarse=2, assign_impl="dense")``: the port's
    ``loss_and_grads`` against the reference's step (its gradients are
    m / (1 - b1) after one step from zero moments), loss at 1e-6,
    gradients at 1e-4 of each field's largest, the overflow counters
    equal; and the same step without ``coarse`` gives the same loss."""
    g, cams, tcams, res = scene(n=300, res=32, n_views=4)
    # anisotropic, as tests/test_torch_train.py's scene: every field trains
    r = np.random.default_rng(0)
    g = g._replace(
        quats=jnp.asarray(r.normal(size=(300, 4)).astype(np.float32)),
        log_scales=g.log_scales + jnp.asarray(r.uniform(
            -0.4, 0.4, size=(300, 3)).astype(np.float32)))
    jgrid, tgrid = grids(32)
    gts, cov = jpl.render_views(jpl.gt_gaussians(*j_point_cloud(
        "sphere_shell", 300, seed=0)), cams, jgrid, K=16)
    masks = np.asarray(jpl.coverage_masks(cov))
    gts = np.asarray(gts)
    vi = np.array([1, 2])
    jcfg = jtr.GSTrainCfg(K=16, tile_h=8, tile_w=16, impl="ref", coarse=2,
                          assign_impl="dense")
    _, jopt, jloss, jov = jax.jit(jtr.make_train_step(
        jcfg, jgrid, 1.7, return_overflow=True))(
        g, jtr.init_opt(g), jc.select(cams, jnp.asarray(vi)),
        jnp.asarray(gts[vi]), jnp.asarray(masks[vi]))
    cfg = ttr.GSTrainCfg(K=16, tile_h=8, tile_w=16, coarse=2,
                         assign_impl="dense")
    assert cfg.coarse == jcfg.coarse == 2
    tg = to_port(g)
    tcam = tc.select(tcams, torch.from_numpy(vi))
    kt = cfg.resolved_k_tiers()
    caps = (tgrid.n_tiles,) * len(kt)
    loss, ov, grads = ttr.loss_and_grads(
        cfg, tgrid, tg, tcam, torch.from_numpy(gts[vi]),
        torch.from_numpy(masks[vi]), k_tiers=kt, tier_caps=caps,
        assign_impl="dense", assign_budget=None)
    assert abs(float(loss) - float(jloss)) <= 1e-6
    assert {k: int(v) for k, v in ov.items()} == \
        {k: int(v) for k, v in jov.items()} == {"tiles": 0, "assign": 0}
    for k in FIELDS:
        want = np.asarray(jopt.m[k]) / np.float32(1 - 0.9)
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    dense = ttr.GSTrainCfg(K=16, tile_h=8, tile_w=16, assign_impl="dense")
    loss_d, _, _ = ttr.loss_and_grads(
        dense, tgrid, tg, tcam, torch.from_numpy(gts[vi]),
        torch.from_numpy(masks[vi]), k_tiers=kt, tier_caps=caps,
        assign_impl="dense", assign_budget=None)
    assert float(loss_d) == float(loss)


@pytest.mark.parametrize("name,R,max_points,t", [
    ("sphere_shell", 48, 5000, 0.0), ("kingsnake", 40, 100_000, 0.1),
    ("kingsnake", 40, 3000, 0.0), ("sphere_shell", 8, 10, 0.0)])
def test_extract_isosurface_matches(name, R, max_points, t):
    """Count equal, points within 1e-7 (the reference's jitted arithmetic
    rounds a last bit differently), padding the first point; the unpadded
    points equal the host extraction's, in its order."""
    f, iso = make_volume(name, R, t=t)
    jp, jcount = j_extract(jnp.asarray(f), iso, max_points=max_points)
    tp, tcount = tiso.extract_isosurface(torch.from_numpy(f), iso,
                                         max_points=max_points)
    assert tcount.dtype == torch.int32 and tp.shape == (max_points, 3)
    n = int(tcount)
    assert n == int(jcount) > 0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    assert (tp[n:] == tp[0]).all()
    host = tiso.crossing_points(f, iso)
    np.testing.assert_array_equal(tp[:n].numpy(), host[:n])
    assert n == min(len(host), max_points)


def test_extract_isosurface_without_crossings():
    f = np.ones((8, 8, 8), np.float32)
    jp, jcount = j_extract(jnp.asarray(f), 0.0, max_points=4)
    tp, tcount = tiso.extract_isosurface(torch.from_numpy(f), 0.0,
                                         max_points=4)
    assert int(tcount) == int(jcount) == 0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
