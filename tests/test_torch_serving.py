"""Port parity: the serving path (core/serving.GSRenderServer).

The same model (built by the JAX package, carried across with
``gaussians_from_numpy``) and the same mixed near/far rig go through the
reference server and the port's server.  Images agree at 1e-5; every
serving decision (rung, K, cache hit, shed) and the whole telemetry dict
are identical, request for request; a port cache hit is bit-identical to
its cold miss.  Shedding, queue-full rejection, LRU eviction and the
zero-budget ``cache_overflow`` counter behave as in the reference.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import serving as js  # noqa: E402
from repro.core.cameras import Camera as JCamera  # noqa: E402
from repro.core.cameras import orbital_rig as j_orbital_rig  # noqa: E402
from repro.core.cameras import select as j_select  # noqa: E402
from repro.core.gaussians import from_points as j_from_points  # noqa: E402
from repro.core.tiling import TileGrid as JGrid  # noqa: E402
from repro.data.isosurface import point_cloud_for as j_point_cloud  # noqa: E402
from repro_torch.core import serving as ts  # noqa: E402
from repro_torch.core.cameras import concat, orbital_rig, select  # noqa: E402
from repro_torch.core.gaussians import gaussians_from_numpy  # noqa: E402
from repro_torch.core.tiling import TileGrid  # noqa: E402

RES = 32
DIMS = (RES, RES, 8, 16)
CENTER = (0.5, 0.5, 0.5)
IMG_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def models(n=400, seed=0):
    """(reference model, the same model in the port) — the scene of the
    reference's own serving suite (tests/test_serving.py)."""
    pts, cols = j_point_cloud("sphere_shell", n, seed=seed)
    g = j_from_points(jnp.asarray(pts), jnp.asarray(cols), opacity=0.9)
    gt = gaussians_from_numpy({k: np.asarray(v) for k, v in
                               g._asdict().items()}, device="cpu")
    return g, gt


def mixed_rigs(n_near=3, n_far=3, far_r=8.0):
    """Near orbit (rung 0) + far orbit (beyond the auto LOD threshold), in
    both packages."""
    near = j_orbital_rig(n_near, CENTER, 1.5, width=RES, height=RES)
    far = j_orbital_rig(n_far, CENTER, far_r, width=RES, height=RES)
    jrig = JCamera(view=jnp.concatenate([near.view, far.view]),
                   fx=jnp.concatenate([near.fx, far.fx]),
                   fy=jnp.concatenate([near.fy, far.fy]),
                   width=RES, height=RES)
    trig = concat([orbital_rig(n_near, CENTER, 1.5, width=RES, height=RES,
                               device="cpu"),
                   orbital_rig(n_far, CENTER, far_r, width=RES, height=RES,
                               device="cpu")])
    return jrig, trig


def servers(**cfg):
    g, gt = models()
    return (js.GSRenderServer(g, JGrid(*DIMS), js.ServeCfg(**cfg),
                              center=CENTER),
            ts.GSRenderServer(gt, TileGrid(*DIMS), ts.ServeCfg(**cfg),
                              center=CENTER))


def assert_results_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.request_id, a.rung, a.K, a.cache_hit, a.shed) == \
            (b.request_id, b.rung, b.K, b.cache_hit, b.shed)
        assert a.rgb.shape == b.rgb.shape and a.coverage.shape == \
            b.coverage.shape
        np.testing.assert_allclose(a.rgb, b.rgb, rtol=IMG_TOL, atol=IMG_TOL)
        np.testing.assert_allclose(a.coverage, b.coverage, rtol=IMG_TOL,
                                   atol=IMG_TOL)


def test_serve_two_passes_match_reference():
    jsrv, tsrv = servers(K=16, max_batch=4, lod_dists=(4.0,))
    jrig, trig = mixed_rigs()
    passes = []
    for _ in range(2):
        got, want = tsrv.serve(trig), jsrv.serve(jrig)
        assert_results_match(got, want)
        passes.append(got)
    cold, warm = passes
    assert {r.rung for r in cold} == {0, 1}
    assert not any(r.cache_hit for r in cold)
    assert all(r.cache_hit for r in warm)
    for c, w in zip(cold, warm):                 # hit == miss, bit for bit
        np.testing.assert_array_equal(c.rgb, w.rgb)
        np.testing.assert_array_equal(c.coverage, w.coverage)
    assert tsrv.telemetry() == jsrv.telemetry()
    assert tsrv.telemetry()["batches"] == 4
    assert tsrv.lod_dists == jsrv.lod_dists
    np.testing.assert_array_equal(tsrv.center, jsrv.center)
    assert tsrv.radius == jsrv.radius
    # the cached table is the reference's table
    cam, jcam = select(trig, 1), j_select(jrig, 1)
    got_t, want_t = tsrv.cached_table(cam), jsrv.cached_table(jcam)
    np.testing.assert_array_equal(got_t[0].numpy(), want_t[0])
    np.testing.assert_allclose(got_t[1].numpy(), want_t[1], rtol=1e-6,
                               atol=0)
    tsrv.clear_cache()
    assert tsrv.cached_table(cam) is None


def test_lod_masks_and_ladder_identical():
    g, gt = models()
    np.testing.assert_array_equal(ts.splat_impact(gt), js.splat_impact(g))
    for frac, cap in ((1.0, None), (0.5, None), (0.4, 32), (1.0, 32)):
        np.testing.assert_array_equal(ts.lod_keep_mask(gt, frac, cap),
                                      js.lod_keep_mask(g, frac, cap))
    want = js.build_lod_ladder(g, (1.0, 0.4, 0.1), cap=24, round_to=64)
    got = ts.build_lod_ladder(gt, (1.0, 0.4, 0.1), cap=24, round_to=64)
    for a, b in zip(got, want):
        for name in b._fields:
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)))
    views = np.asarray(mixed_rigs()[0].view)
    for v in views:
        assert ts.camera_distance(torch.from_numpy(np.array(v)), CENTER) == \
            js.camera_distance(v, CENTER)
        np.testing.assert_array_equal(ts.camera_eye(v), js.camera_eye(v))
    for d in np.linspace(0.0, 10.0, 21):
        assert ts.select_rung(d, (2.0, 4.0)) == js.select_rung(d, (2.0, 4.0))


def test_load_shedding_matches_reference():
    jsrv, tsrv = servers(K=16, max_batch=4, shed_at=2, shed_rung=0)
    jrig = j_orbital_rig(6, CENTER, 1.5, width=RES, height=RES)
    trig = orbital_rig(6, CENTER, 1.5, width=RES, height=RES, device="cpu")
    for v in range(6):
        assert tsrv.submit(select(trig, v)) == jsrv.submit(j_select(jrig, v))
    got, want = tsrv.flush(), jsrv.flush()
    assert_results_match(got, want)
    assert [r.shed for r in got] == [False, False, True, True, True, True]
    assert [r.K for r in got] == [16, 16, 2, 2, 2, 2]
    assert tsrv.telemetry() == jsrv.telemetry()


def test_queue_full_rejection_matches_reference():
    jsrv, tsrv = servers(K=16, max_batch=4, queue_cap=2)
    jrig = j_orbital_rig(3, CENTER, 1.5, width=RES, height=RES)
    trig = orbital_rig(3, CENTER, 1.5, width=RES, height=RES, device="cpu")
    for srv, rig, sel, err in ((tsrv, trig, select, ts.QueueFullError),
                               (jsrv, jrig, j_select, js.QueueFullError)):
        srv.submit(sel(rig, 0))
        srv.submit(sel(rig, 1))
        with pytest.raises(err):
            srv.submit(sel(rig, 2))
        assert srv.telemetry()["rejected"] == 1
        assert srv.pending == 2
    assert_results_match(tsrv.flush(), jsrv.flush())
    assert_results_match(tsrv.serve(trig), jsrv.serve(jrig))   # no reject
    assert tsrv.telemetry() == jsrv.telemetry()


@pytest.mark.parametrize("entries", [0, 1])
def test_cache_budget_counters_match_reference(entries):
    """Zero budget: every insert counted as cache_overflow, nothing hits;
    one entry: LRU evictions counted."""
    jsrv, tsrv = servers(K=16, max_batch=4, cache_entries=entries)
    jrig, trig = mixed_rigs()
    for _ in range(2):
        got = tsrv.serve(trig)
        assert_results_match(got, jsrv.serve(jrig))
        assert all(np.isfinite(r.rgb).all() for r in got)
    tel = tsrv.telemetry()
    assert tel == jsrv.telemetry()
    if entries == 0:
        assert tel["cache_overflow"] > 0 and tel["hits"] == 0
    else:
        assert tel["evictions"] > 0


def test_starved_assign_budget_counted_and_grown():
    """A pinned sorted path with a starved budget: the overflow is counted
    in telemetry["assign"] and the budget grows — as in the reference."""
    jsrv, tsrv = servers(K=16, max_batch=4, assign_impl="sorted",
                         assign_budget=1)
    jrig, trig = mixed_rigs()
    assert_results_match(tsrv.serve(trig), jsrv.serve(jrig))
    assert tsrv.telemetry() == jsrv.telemetry()
    assert tsrv.telemetry()["assign"] > 0
    assert tsrv._assign == jsrv._assign


def test_validation_matches_reference():
    g, gt = models()
    tsrv = ts.GSRenderServer(gt, TileGrid(*DIMS), ts.ServeCfg(K=16),
                             center=CENTER)
    trig = orbital_rig(2, CENTER, 1.5, width=RES, height=RES, device="cpu")
    with pytest.raises(ValueError):
        tsrv.submit(trig)                            # batched rig
    bad = orbital_rig(1, CENTER, 1.5, width=64, height=64, device="cpu")
    with pytest.raises(ValueError):
        tsrv.submit(select(bad, 0))                  # grid mismatch
    with pytest.raises(ValueError):
        ts.ServeCfg(K=16, k_ladder=(8, 4, 16)).resolved_ladder()
    with pytest.raises(ValueError):
        ts.ServeCfg(K=16, k_ladder=(4, 8)).resolved_ladder()
    with pytest.raises(ValueError):
        ts.ServeCfg(dtype_policy="fp8")
    with pytest.raises(ValueError):
        ts.GSRenderServer(gt, TileGrid(*DIMS), ts.ServeCfg(K=16, shed_rung=7))
    with pytest.raises(ValueError):
        ts.GSRenderServer(gt, TileGrid(*DIMS),
                          ts.ServeCfg(K=16, lod_fracs=(1.0, 0.5),
                                      lod_dists=(1.0, 2.0)))
    for K, ladder in ((64, ()), (16, (2, 16)), (3, ())):
        cfg = dict(K=K, k_ladder=ladder)
        assert ts.ServeCfg(**cfg).resolved_ladder() == \
            js.ServeCfg(**cfg).resolved_ladder()
    assert hash(ts.ServeCfg()) == hash(dataclasses.replace(ts.ServeCfg()))
    assert [f.name for f in dataclasses.fields(ts.ServeCfg)] == \
        [f.name for f in dataclasses.fields(js.ServeCfg)]
    assert ts.ServeCfg().__dict__ == js.ServeCfg().__dict__
