"""Port parity: tile assignment and the table helpers, on BRIDGED splats.

Assignment is compared on the reference's own ``Splats2D`` (numpy-built or
projected by the JAX package) handed to both packages, so the two sides
see bit-identical inputs and must give bit-identical tables: indices,
scores, empty slots (idx 0 / score NEG) and overflow counts.  The cases
cover equal-depth ties, saturated K, empty tiles, dead splats, splats
behind the camera and a starved sorted-path budget.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import tiling as jt  # noqa: E402
from repro.core.cameras import orbital_rig as j_orbital_rig  # noqa: E402
from repro.core.cameras import select as j_select  # noqa: E402
from repro.core.gaussians import from_points as j_from_points  # noqa: E402
from repro.core.projection import Splats2D as JSplats  # noqa: E402
from repro.core.projection import project as j_project  # noqa: E402
from repro_torch.core import tiling as tt  # noqa: E402
from repro_torch.core.projection import Splats2D  # noqa: E402

RES = 64
GRID = (RES, RES, 8, 16)                  # 8 x 4 = 32 tiles


def synth_splats(seed, N=96, *, tie_depths=None, dead_frac=0.15,
                 behind_frac=0.0, corner=False, max_r=20):
    """Reference Splats2D as numpy arrays: random means/radii over the
    image, optional depth ties, dead splats, splats behind the camera
    (negative depth, invalid) and a corner cluster that leaves tiles
    empty."""
    r = np.random.default_rng(seed)
    hi = RES / 3 if corner else RES
    mean = r.uniform(-4, hi, size=(N, 2)).astype(np.float32)
    radius = r.integers(1, max_r, size=N).astype(np.float32)
    if tie_depths is None:
        depth = r.uniform(0.5, 4.0, size=N)
    else:
        depth = r.choice(np.asarray(tie_depths), size=N)
    depth = depth.astype(np.float32)
    valid = r.uniform(size=N) >= dead_frac
    behind = r.uniform(size=N) < behind_frac
    depth[behind] = -depth[behind]
    valid &= ~behind
    a = r.uniform(1.0, 30.0, size=N)
    c = r.uniform(1.0, 30.0, size=N)
    b = r.uniform(-0.5, 0.5, size=N) * np.sqrt(a * c)
    return dict(mean2d=mean, cov2d=np.stack([a, b, c], -1).astype(np.float32),
                depth=depth, rgb=r.uniform(size=(N, 3)).astype(np.float32),
                alpha=r.uniform(0.05, 0.95, size=N).astype(np.float32),
                radius=radius, valid=valid)


def both(d):
    """numpy Splats2D fields -> (reference Splats2D, port Splats2D)."""
    return (JSplats(**{k: jnp.asarray(v) for k, v in d.items()}),
            Splats2D(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()}))


@functools.lru_cache(maxsize=None)
def j_assign(dims, K, impl, budget=None):
    """Jitted reference assignment (one compile per static config)."""
    grid = jt.TileGrid(*dims)
    return jax.jit(lambda s: jt.assign_tiles(
        s, grid, K=K, impl=impl, tile_budget=budget, return_overflow=True))


@functools.lru_cache(maxsize=None)
def projected_splats(seed=0, n=300, radius=1.5):
    """The reference's projection of a point-cloud scene, as numpy."""
    r = np.random.default_rng(seed)
    pts = r.uniform(0.2, 0.8, size=(n, 3)).astype(np.float32)
    g = j_from_points(jnp.asarray(pts), opacity=0.8)
    cam = j_select(j_orbital_rig(2, (0.5, 0.5, 0.5), radius, width=RES,
                                 height=RES), 0)
    return {k: np.asarray(v) for k, v in j_project(g, cam)._asdict().items()}


def assert_tables_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


CASES = {
    "random": dict(seed=0),
    "equal_depth_ties": dict(seed=1, tie_depths=(1.0, 2.0, 3.0)),
    "all_one_depth": dict(seed=2, tie_depths=(1.5,)),
    "empty_tiles": dict(seed=3, corner=True),
    "dead_splats": dict(seed=4, dead_frac=0.6),
    "behind_camera": dict(seed=5, behind_frac=0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("K", [4, 16])
def test_dense_and_sorted_bit_identical_to_reference(case, K):
    js, ts = both(synth_splats(**CASES[case]))
    tgrid = tt.TileGrid(*GRID)
    want = j_assign(GRID, K, "dense")(js)
    dense = tt.assign_tiles(ts, tgrid, K=K, impl="dense",
                            return_overflow=True)
    assert_tables_equal(dense, want)
    # an exact budget (every tile) under jit; the port sizes it exactly
    want_s = j_assign(GRID, K, "sorted", tgrid.n_tiles)(js)
    got_s = tt.assign_tiles_sorted(ts, tgrid, K=K, return_overflow=True)
    assert_tables_equal(got_s, want_s)
    assert_tables_equal(got_s, want)      # sorted == dense, both packages
    # K=4 saturates: some tile holds more than K overlapping splats
    if K == 4 and case == "random":
        assert (np.asarray(want[1]) > jt.NEG / 2).all(axis=-1).any()


def test_dense_sweep_block_size_is_invisible():
    """The running top-k merge is a pure function of the candidate set."""
    _, ts = both(synth_splats(7, N=200, tie_depths=(1.0, 2.0)))
    tgrid = tt.TileGrid(*GRID)
    full = tt.assign_tiles(ts, tgrid, K=8, impl="dense")
    for block in (8, 33):
        assert_tables_equal(tt.assign_tiles(ts, tgrid, K=8, impl="dense",
                                            block=block), full)


def test_projected_splats_bit_identical():
    js, ts = both(projected_splats())
    tgrid = tt.TileGrid(*GRID)
    for impl, budget in (("dense", None), ("sorted", tgrid.n_tiles)):
        want = j_assign(GRID, 16, impl, budget)(js)
        got = tt.assign_tiles(ts, tgrid, K=16, impl=impl,
                              return_overflow=True)
        assert_tables_equal(got, want)


@pytest.mark.parametrize("budget", [1, 2, 5])
def test_starved_budget_overflow_matches(budget):
    js, ts = both(synth_splats(8, max_r=24))
    want = j_assign(GRID, 16, "sorted", budget)(js)
    got = tt.assign_tiles_sorted(ts, tt.TileGrid(*GRID), K=16,
                                 tile_budget=budget, return_overflow=True)
    assert int(want[2]) > 0
    assert_tables_equal(got, want)


def test_traced_budget_rule_matches_jit():
    """Under jit the reference sizes a missing sorted budget as
    DEFAULT_TILE_BUDGET; the port's exact_budget=False is that rule, the
    default (eager) is the exact one."""
    d = synth_splats(9, max_r=40)
    js, ts = both(d)
    grid = jt.TileGrid(RES, RES, 8, 8)        # 64 tiles: bboxes exceed 16
    tgrid = tt.TileGrid(RES, RES, 8, 8)
    jitted = jax.jit(lambda s: jt.assign_tiles_sorted(
        s, grid, K=8, return_overflow=True))(js)
    traced = tt.assign_tiles_sorted(ts, tgrid, K=8, return_overflow=True,
                                    exact_budget=False)
    assert int(jitted[2]) > 0
    assert_tables_equal(traced, jitted)
    eager = jt.assign_tiles_sorted(js, grid, K=8, return_overflow=True)
    exact = tt.assign_tiles_sorted(ts, tgrid, K=8, return_overflow=True)
    assert int(eager[2]) == 0
    assert_tables_equal(exact, eager)


def test_sorted_window_matches_reference():
    d = synth_splats(10)
    grid, tgrid = jt.TileGrid(*GRID), tt.TileGrid(*GRID)
    cols = ("mean2d", "radius", "valid", "depth")
    jm, jr, jv, jd = (jnp.asarray(d[k]) for k in cols)
    tm, tr, tv, td = (torch.from_numpy(np.array(d[k])) for k in cols)
    window = jax.jit(
        lambda m, r, v, d, t0, n_local: jt.sorted_assign_window(
            m[:, 0], m[:, 1], r, v, d, grid, K=8, t0=t0, n_local=n_local,
            tile_budget=32), static_argnames="n_local")
    for t0, n_local in ((0, 12), (10, 9), (24, 8)):
        want = window(jm, jr, jv, jd, t0, n_local=n_local)
        got = tt.sorted_assign_window(tm[:, 0], tm[:, 1], tr, tv, td, tgrid,
                                      K=8, t0=t0, n_local=n_local,
                                      tile_budget=32)
        assert_tables_equal(got, want)


def test_topk_tie_order_is_score_then_index():
    r = np.random.default_rng(11)
    s = r.choice(np.float32([-1.0, -2.0, jt.NEG]), size=(5, 40))
    i = np.stack([r.permutation(40) for _ in range(5)]).astype(np.int32)
    got = tt.topk_by_score_then_index(torch.from_numpy(s),
                                      torch.from_numpy(i), 12)
    for row in range(5):
        order = sorted(range(40), key=lambda c: (-s[row, c], i[row, c]))[:12]
        np.testing.assert_array_equal(got[0][row].numpy(), s[row, order])
        np.testing.assert_array_equal(got[1][row].numpy(), i[row, order])
    # the reference's lax.top_k agrees wherever its precondition holds
    # (indices ascending within ties)
    srt = np.argsort(i, axis=-1, kind="stable")
    si, ss = np.take_along_axis(i, srt, -1), np.take_along_axis(s, srt, -1)
    want = jt.topk_by_score_then_index(jnp.asarray(ss), jnp.asarray(si), 12)
    assert_tables_equal(got, want)


def test_counts_budgets_and_ladder_helpers():
    js, ts = both(synth_splats(12, behind_frac=0.2, max_r=30))
    grid, tgrid = jt.TileGrid(*GRID), tt.TileGrid(*GRID)
    np.testing.assert_array_equal(tt.splat_tile_counts(ts, tgrid).numpy(),
                                  np.asarray(jt.splat_tile_counts(js, grid)))
    for n_tiles in (1, 32, 4096):
        for b in (None, 0, 5, 17, 10_000):
            assert tt.resolve_tile_budget(n_tiles, b) == \
                jt.resolve_tile_budget(n_tiles, b)
            if b is not None:
                assert tt.auto_tile_budget(b, n_tiles) == \
                    jt.auto_tile_budget(b, n_tiles)
                assert tt.grow_tile_budget(b, n_tiles) == \
                    jt.grow_tile_budget(b, n_tiles)
            for impl in ("auto", "dense", "sorted"):
                assert tt.resolve_assign_impl(impl, n_tiles, b) == \
                    jt.resolve_assign_impl(impl, n_tiles, b)
    with pytest.raises(ValueError):
        tt.resolve_assign_impl("coarse", 32)
    sched = tt.TierSchedule((8, 32, 64))
    assert sched.kmax == jt.TierSchedule((8, 32, 64)).kmax == 64
    assert sched.k_tiers == (8, 32, 64)
    for bad in ((), (8, 8), (32, 8)):
        with pytest.raises(ValueError):
            tt.TierSchedule(bad)


def test_features_gather_untile():
    d = projected_splats(seed=13)
    js, ts = both(d)
    grid, tgrid = jt.TileGrid(*GRID), tt.TileGrid(*GRID)
    feat_j = jt.splat_features(js)
    feat_t = tt.splat_features(ts)
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j),
                               rtol=1e-6, atol=1e-6)
    idx, score, _ = j_assign(GRID, 8, "dense")(js)
    tf = tt.gather_features_at(feat_t, torch.from_numpy(np.array(idx)),
                               torch.from_numpy(np.array(score)))
    np.testing.assert_allclose(tf.numpy(), np.asarray(
        jt.gather_features_at(feat_j, idx, score)), rtol=1e-6, atol=1e-6)
    # view-batched table: (V, N, F) with (V, T, K)
    fb = torch.stack([feat_t, feat_t.flip(0)])
    ib = torch.stack([torch.from_numpy(np.array(idx))] * 2)
    sb = torch.stack([torch.from_numpy(np.array(score))] * 2)
    tb = tt.gather_features_at(fb, ib, sb)
    np.testing.assert_array_equal(tb[0].numpy(), tf.numpy())
    np.testing.assert_array_equal(
        tb[1].numpy(), tt.gather_features_at(feat_t.flip(0), ib[0],
                                             sb[0]).numpy())
    # untile: exact layout permutation, cropped grid included
    for dims in (GRID, (60, 44, 8, 16)):
        g2, t2 = jt.TileGrid(*dims), tt.TileGrid(*dims)
        tiles = np.random.default_rng(14).normal(
            size=(g2.n_tiles, 4, g2.tile_h, g2.tile_w)).astype(np.float32)
        want = np.asarray(jt.untile_image(jnp.asarray(tiles), g2))
        got = tt.untile_image(torch.from_numpy(tiles), t2).numpy()
        np.testing.assert_array_equal(got, want)
        got_b = tt.untile_image(torch.from_numpy(np.stack([tiles] * 2)), t2)
        np.testing.assert_array_equal(got_b[1].numpy(), want)
    np.testing.assert_array_equal(tt.tile_origins(tgrid, "cpu").numpy(),
                                  np.asarray(jt.tile_origins(grid)))
    with pytest.raises(TypeError):           # the device is not defaulted
        tt.tile_origins(tgrid)


def test_quantize_pose_and_slice_table():
    r = np.random.default_rng(15)
    for _ in range(5):
        view = r.normal(size=(4, 4)).astype(np.float32)
        fx, fy = np.float32(r.uniform(20, 2000)), np.float32(r.uniform(20, 2000))
        for bins in (jt.POSE_BINS, 64.0):
            key, (v, cfx, cfy) = jt.quantize_pose(view, fx, fy, bins=bins)
            tkey, (tv, tfx, tfy) = tt.quantize_pose(
                torch.from_numpy(view), torch.tensor(fx), torch.tensor(fy),
                bins=bins)
            assert tkey == key
            np.testing.assert_array_equal(tv, v)
            assert (tfx, tfy) == (cfx, cfy)
    idx = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    score = -idx.to(torch.float32)
    si, ss = tt.slice_table(idx, score, 2)
    wi, ws = jt.slice_table(np.asarray(idx), np.asarray(score), 2)
    np.testing.assert_array_equal(si.numpy(), wi)
    np.testing.assert_array_equal(ss.numpy(), ws)
    with pytest.raises(ValueError):
        tt.slice_table(idx, score, 5)
