"""Port parity: occupancy tiers, the tier schedule and the tiered render.

Binning is integer bookkeeping, so the port must match the JAX package bit
for bit: ``tile_occupancy``, ``tile_tiers``, ``bin_tiles_by_occupancy``
(compacted ids, counts, overflow, under promotion and overflow), the cap
sizers, and ``TierSchedule``'s JSON state.  Tiered renders of the same
(bridged) model agree with the reference at the rasterizer's 1e-5 gate,
and equal the port's own dense render at K = k_tiers[-1] when the caps
cover.
"""

import functools
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cameras as jc  # noqa: E402
from repro.core import gaussians as jg  # noqa: E402
from repro.core import tiling as jt  # noqa: E402
from repro.data.isosurface import point_cloud_for as j_point_cloud  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import cameras as tc  # noqa: E402
from repro_torch.core import tiling as tt  # noqa: E402
from repro_torch.core.gaussians import gaussians_from_numpy  # noqa: E402
from repro_torch.core.render import (occupancy_probe, render,  # noqa: E402
                                     render_batch, render_tiles,
                                     view_occupancy)
from repro_torch.kernels import ops  # noqa: E402

jr = importlib.import_module("repro.core.render")

RES = 32
DIMS = (RES, RES, 8, 16)            # 4 x 4 = 16 tiles
CENTER = (0.5, 0.5, 0.5)
IMG_TOL = 1e-5
LADDER = (8, 32, 64)


def occupancies(seed, shape, hi=80, empty_frac=0.25):
    """Random int32 occupancies in [0, hi] with empty tiles mixed in."""
    r = np.random.default_rng(seed)
    occ = r.integers(0, hi + 1, size=shape)
    occ[r.uniform(size=shape) < empty_frac] = 0
    return occ.astype(np.int32)


def assert_plan_equal(got, want):
    assert len(got.tile_ids) == len(want.tile_ids)
    for a, b in zip(got.tile_ids, want.tile_ids):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


@pytest.mark.parametrize("caps", [(64, 64, 64), (6, 4, 3), (0, 5, 0),
                                  (2, 0, 40)])
def test_binning_bit_identical(caps):
    """Roomy caps, caps that force promotion and overflow, and zero caps:
    ids, counts and overflow equal the reference's, single and batched."""
    occ = occupancies(len(caps) + sum(caps), (48,))
    want_t = jt.tile_tiers(jnp.asarray(occ), LADDER)
    got_t = tt.tile_tiers(torch.from_numpy(occ), LADDER)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(
        tt.tile_occupancy(torch.from_numpy(np.where(
            np.arange(8)[None] < occ[:, None], 1.0, tt.NEG)
            .astype(np.float32))).numpy(),
        np.minimum(occ, 8))
    want = jt.bin_tiles_by_occupancy(jnp.asarray(occ), LADDER, caps)
    got = tt.bin_tiles_by_occupancy(torch.from_numpy(occ), LADDER, caps)
    assert_plan_equal(got, want)
    if caps == (6, 4, 3):
        assert int(want.overflow) > 0 and int(want.counts[1]) == 4
    batch = occupancies(99, (3, 48))
    want_b = jax.vmap(lambda o: jt.bin_tiles_by_occupancy(o, LADDER, caps))(
        jnp.asarray(batch))
    assert_plan_equal(tt.bin_tiles_by_occupancy(torch.from_numpy(batch),
                                                LADDER, caps), want_b)


def test_binning_rejects_bad_ladders():
    occ = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tt.bin_tiles_by_occupancy(occ, (8, 32), (4,))
    with pytest.raises(ValueError):
        tt.bin_tiles_by_occupancy(occ, (32, 8), (4, 4))


def test_cap_sizers_equal():
    for seed, shape in ((0, (64,)), (1, (3, 64)), (2, (2, 5, 16))):
        occ = occupancies(seed, shape)
        for slack, round_to in ((1.0, 8), (1.25, 8), (1.5, 16)):
            assert tt.auto_tier_caps(occ, LADDER, slack=slack,
                                     round_to=round_to) == \
                jt.auto_tier_caps(occ, LADDER, slack=slack,
                                  round_to=round_to)
            assert tt.auto_tier_caps(torch.from_numpy(occ), LADDER,
                                     slack=slack) == \
                jt.auto_tier_caps(occ, LADDER, slack=slack)
        assert tt._tier_counts(occ, LADDER) == jt._tier_counts(occ, LADDER)
    for counts in ((0, 3, 17), (5, 0, 0), (100, 1, 9)):
        for kw in (dict(limit=64), dict(slack=1.3, round_to=4, limit=40)):
            assert tt.caps_from_tier_counts(counts, **kw) == \
                jt.caps_from_tier_counts(counts, **kw)


@pytest.mark.parametrize("trim", [False, True])
def test_schedule_lifecycle_json_identical(trim):
    """probe -> note_overflow (grow, clamp) -> re-probe -> state_dict: the
    same JSON in both packages, and each loads the other's state."""
    mine = tt.TierSchedule((4, 16, 64), slack=1.25, trim=trim)
    theirs = jt.TierSchedule((4, 16, 64), slack=1.25, trim=trim)
    assert json.dumps(mine.state_dict()) == json.dumps(theirs.state_dict())
    steps = [("probe", occupancies(3, (2, 40), hi=20)),
             ("ov", 0), ("ov", 3), ("ov", 7), ("ov", 9),
             ("probe", occupancies(4, (40,), hi=70)), ("ov", 1)]
    for kind, x in steps:
        if kind == "probe":
            assert mine.probe(torch.from_numpy(x)) == theirs.probe(x)
        else:
            assert mine.note_overflow(torch.tensor(x), 40) == \
                theirs.note_overflow(jnp.asarray(x), 40)
        assert json.dumps(mine.state_dict()) == \
            json.dumps(theirs.state_dict())
    assert mine.probe_counts([1, 2, 3], 30, n_tiles=16) == \
        theirs.probe_counts([1, 2, 3], 30, n_tiles=16)
    state = json.loads(json.dumps(theirs.state_dict()))
    back = tt.TierSchedule.from_state(state)
    assert back.state_dict() == state and back.kmax == theirs.kmax
    assert jt.TierSchedule.from_state(mine.state_dict()).state_dict() == \
        mine.state_dict()
    with pytest.raises(ValueError):
        mine.probe_counts([1, 2], 3, n_tiles=16)


def test_tile_image_inverts_untile():
    for dims in (DIMS, (60, 44, 8, 16)):
        grid, tgrid = jt.TileGrid(*dims), tt.TileGrid(*dims)
        img = np.random.default_rng(5).normal(
            size=(dims[1], dims[0], 3)).astype(np.float32)
        want = np.asarray(jt.tile_image(jnp.asarray(img), grid))
        got = tt.tile_image(torch.from_numpy(img), tgrid)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tt.untile_image(
            torch.cat([got, got[:, :1]], 1), tgrid)[..., :3].numpy(), img)


def test_tile_image_leading_dims_match_reference_vmap():
    """(P, V, H, W, C) images tile as the reference's ``tile_image``
    vmapped over both leading axes (the distributed batch layout)."""
    dims = (60, 44, 8, 16)
    grid, tgrid = jt.TileGrid(*dims), tt.TileGrid(*dims)
    img = np.random.default_rng(6).normal(
        size=(2, 3, dims[1], dims[0], 1)).astype(np.float32)
    tile = jax.vmap(jax.vmap(lambda x: jt.tile_image(x, grid)))
    want = np.asarray(tile(jnp.asarray(img)))
    got = tt.tile_image(torch.from_numpy(img), tgrid)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rasterize_tiles_tiered_matches_reference():
    """Two non-empty tiers (K 4 and 16) and an empty one, padded slots
    carrying the sentinel id, into a 10-tile image."""
    r = np.random.default_rng(8)
    n_tiles, th, tw = 10, 8, 16
    ks, caps = (4, 8, 16), (3, 0, 4)
    ids = [np.array([7, 2, n_tiles], np.int32), np.zeros((0,), np.int32),
           np.array([0, 5, n_tiles, n_tiles], np.int32)]
    feats, origins = [], []
    for k, cap in zip(ks, caps):
        f = np.zeros((cap, k, 16), np.float32)
        f[..., :2] = r.uniform(0, 16, size=(cap, k, 2))
        f[..., 2] = f[..., 4] = r.uniform(0.05, 0.5, size=(cap, k))
        f[..., 5:9] = r.uniform(0.1, 0.9, size=(cap, k, 4))
        feats.append(f)
        origins.append(np.zeros((cap, 2), np.float32))
    want = jops.rasterize_tiles_tiered(
        [jnp.asarray(f) for f in feats], [jnp.asarray(o) for o in origins],
        [jnp.asarray(i) for i in ids], n_tiles, tile_h=th, tile_w=tw,
        impl="ref")
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    got = ops.rasterize_tiles_tiered(
        tf, [torch.from_numpy(o) for o in origins],
        [torch.from_numpy(i) for i in ids], n_tiles, tile_h=th, tile_w=tw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=IMG_TOL, atol=IMG_TOL)
    assert got[[1, 3, 4, 6, 8, 9]].abs().max().item() == 0.0
    got.sum().backward()                       # padded slots get no gradient
    assert tf[0].grad[2].abs().max().item() == 0.0
    assert tf[2].grad[2:].abs().max().item() == 0.0
    assert tf[2].grad[:2].abs().max().item() > 0.0


def j_model(n=300, seed=0):
    pts, cols = j_point_cloud("sphere_shell", n, seed=seed)
    return jg.from_points(jnp.asarray(pts), jnp.asarray(cols), opacity=0.9)


def to_port(g):
    return gaussians_from_numpy({k: np.asarray(v) for k, v in
                                 g._asdict().items()}, device="cpu")


@functools.lru_cache(maxsize=None)
def j_render_batch(dims, k_tiers, tier_caps):
    grid = jt.TileGrid(*dims)
    return jax.jit(lambda g, c: jr.render_batch(
        g, c, grid, k_tiers=k_tiers, tier_caps=tier_caps, impl="ref"))


@pytest.mark.parametrize("k_tiers,tier_caps", [((4, 16), (16, 16)),
                                               ((2, 8, 16), (2, 2, 4))])
def test_tiered_render_matches_reference(k_tiers, tier_caps):
    """render_batch / render with k_tiers on the same bridged model: images
    at 1e-5 and the same overflow counters -- roomy caps, and starved caps
    that promote and drop tiles."""
    g = j_model(seed=4)
    cams = jc.orbital_rig(3, CENTER, 1.5, width=RES, height=RES)
    tcams = tc.orbital_rig(3, CENTER, 1.5, width=RES, height=RES,
                           device="cpu")
    gt = to_port(g)
    grid = tt.TileGrid(*DIMS)
    want = j_render_batch(DIMS, k_tiers, tier_caps)(g, cams)
    got = render_batch(gt, tcams, grid, k_tiers=k_tiers, tier_caps=tier_caps)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                               rtol=IMG_TOL, atol=IMG_TOL)
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    one = render(gt, tc.select(tcams, 1), grid, k_tiers=k_tiers,
                 tier_caps=tier_caps)
    np.testing.assert_allclose(one.rgb.numpy(), np.asarray(want.rgb[1]),
                               rtol=IMG_TOL, atol=IMG_TOL)
    assert int(one.overflow) == int(np.asarray(want.overflow)[1])
    if tier_caps == (2, 2, 4):
        assert int(np.asarray(want.overflow).sum()) > 0


def test_tiered_equals_dense_when_caps_cover():
    g = to_port(j_model(seed=6))
    cams = tc.orbital_rig(2, CENTER, 1.4, width=RES, height=RES,
                          device="cpu")
    grid = tt.TileGrid(*DIMS)
    dense = render_batch(g, cams, grid, K=16)
    for caps in (None, (16, 16, 16)):
        tiered = render_batch(g, cams, grid, k_tiers=(2, 8, 16),
                              tier_caps=caps)
        assert int(tiered.overflow.sum()) == 0
        np.testing.assert_allclose(tiered.rgb.numpy(), dense.rgb.numpy(),
                                   rtol=IMG_TOL, atol=IMG_TOL)
    tiles, idx, score = render_tiles(g, tc.select(cams, 0), grid,
                                     k_tiers=(2, 8, 16))
    dtiles, didx, _ = render_tiles(g, tc.select(cams, 0), grid, K=16)
    np.testing.assert_array_equal(idx.numpy(), didx.numpy())
    np.testing.assert_allclose(tiles.numpy(), dtiles.numpy(), rtol=IMG_TOL,
                               atol=IMG_TOL)


def test_occupancy_probe_matches_reference():
    g = j_model(seed=7)
    cams = jc.orbital_rig(3, CENTER, 1.3, width=RES, height=RES)
    tcams = tc.orbital_rig(3, CENTER, 1.3, width=RES, height=RES,
                           device="cpu")
    gt = to_port(g)
    grid = tt.TileGrid(*DIMS)
    for impl in ("dense", "sorted"):
        want = jr.occupancy_probe_jit(jt.TileGrid(*DIMS), 16, None, impl)(
            g, cams)
        got = occupancy_probe(gt, tcams, grid, K=16, assign_impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        view_occupancy(gt, tcams, grid, K=16).numpy(), np.asarray(want))


def test_render_views_tiered_caps_grow_and_warn_as_reference():
    """``render_views`` with ``k_tiers``: caps auto-sized on the first
    chunk (a far view) grow on a later, fuller chunk (a near view) and the
    images stay exact (equal to the reference's and to the port's dense
    render at 1e-5); explicit undersized caps are kept, and the tiles they
    drop are reported by a RuntimeWarning, as the reference does."""
    jpl = importlib.import_module("repro.core.pipeline")
    tpl = importlib.import_module("repro_torch.core.pipeline")
    g = j_model(n=600, seed=0)
    res, kt = 48, (4, 16, 64)
    rigs = [(4.0, 1), (1.2, 1)]                       # far, then near
    jcams = [jc.orbital_rig(n, CENTER, r, width=res, height=res)
             for r, n in rigs]
    jcams = jcams[0]._replace(**{f: jnp.concatenate(
        [getattr(c, f) for c in jcams]) for f in ("view", "fx", "fy")})
    tcams = tc.concat([tc.orbital_rig(n, CENTER, r, width=res, height=res,
                                      device="cpu") for r, n in rigs])
    dims = (res, res, 8, 16)
    gt, grid = to_port(g), tt.TileGrid(*dims)
    want, _ = jpl.render_views(g, jcams, jt.TileGrid(*dims), K=64,
                               impl="ref", k_tiers=kt, batch=1)
    got, _ = tpl.render_views(gt, tcams, grid, K=64, k_tiers=kt, batch=1)
    dense, _ = tpl.render_views(gt, tcams, grid, K=64, batch=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=IMG_TOL,
                               atol=IMG_TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=IMG_TOL,
                               atol=IMG_TOL)
    first = render_batch(gt, tc.select(tcams, torch.tensor([0])), grid,
                         k_tiers=kt)
    caps0 = tt.auto_tier_caps(view_occupancy(
        gt, tc.select(tcams, torch.tensor([0])), grid, K=kt[-1]), kt,
        slack=1.25)
    near = render_batch(gt, tc.select(tcams, torch.tensor([1])), grid,
                        k_tiers=kt, tier_caps=caps0)
    assert int(first.overflow.sum()) == 0 < int(near.overflow.sum())
    with pytest.warns(RuntimeWarning, match="overflowed"):
        small, _ = tpl.render_views(gt, tcams, grid, K=64, k_tiers=kt,
                                    tier_caps=(1, 1, 1))
    with pytest.warns(RuntimeWarning, match="overflowed"):
        jsmall, _ = jpl.render_views(g, jcams, jt.TileGrid(*dims), K=64,
                                     impl="ref", k_tiers=kt,
                                     tier_caps=(1, 1, 1))
    np.testing.assert_allclose(small.numpy(), np.asarray(jsmall),
                               rtol=IMG_TOL, atol=IMG_TOL)
