"""Port parity: the sparse-overlap exchange of the distributed trainer
(``exchange=True``: the budgeted all-to-all and ragged ladder in place of
the "part" all-gather, ``ExchangeSchedule``, ``window_assignment``,
``rebalance_partitions``, ``fit_partitions``' exchange hooks) against the
JAX package and against the port's own all-gather path.

One spawned world of four gloo ranks (``_torch_dist``: torch only, a
``file://`` rendezvous, a join deadline and a 60 s collective timeout)
builds three meshes on itself -- ("part", "view") 2x2, ("part",) x4 and
("part", "model") 2x2 -- while the reference runs in this process on one
CPU device.  Scene X is the reference's ``EXCHANGE_SCRIPT`` scene
(``tests/test_distributed.py:777``): two partitions, the halves of a
512-point sphere_shell cloud at opacity 0.8, 32x32 images in 8x16 tiles
(T = 8), two views, zero targets, every pixel masked in, K = 16 -- with
exact depth ties across the "part" shards (``scene_x``).  Scene D
is its ``EXDRIVER_SCRIPT`` scene: one partition of 256 points (jittered
by 1e-4 so no two depth scores tie) in 384 slots, four views, the cloud's
renders at opacity 0.95 as targets.  Gates, each with its reason:

- the host pieces (``window_overlap_mask``, ``check_budget_matrix``,
  ``window_assignment``, every ``ExchangeSchedule`` method on
  ``tests/test_distributed.py:656-742``'s inputs, ``rebalance_partitions``'
  permutation, ``folded_tile_count``) equal the reference's exactly: the
  same integer and numpy arithmetic;
- the exchange against the port's gather on the same mesh, as the
  reference holds its own (``EXCHANGE_SCRIPT``): tiles at 1e-6, loss at
  rtol 1e-6 / atol 1e-7, one step's trainables at 1e-6, every counter 0,
  the in-step demand equal to the host probe exactly -- the received table
  is an order-preserving subsequence of the gathered one, so the same
  splats composite in the same order and only float sums may reassociate;
- the exchange against the reference's one-device (1x1) forward and step:
  tiles at 1e-6, loss at rtol 1e-5 / atol 1e-6, stepped trainables at
  1e-6 (``tests/test_torch_distributed.py``'s step gates: the two
  packages' projections differ by one rounding, ROADMAP queue 3);
- the ("part", "model") mesh with two partitions a rank against the
  reference's single-device ``render_tiles`` at 1e-6, not its distributed
  step, which misplaces tiles there (ROADMAP queue 3);
- the bf16 policy and the split mode: exchange equals gather within the
  policy at 1e-6, as ``BF16_SCRIPT`` holds it (both move the same rounded
  rows);
- the driver against the port's gather driver (the reference's
  ``test_exchange_driver_lifecycle`` is a red): the tiered probe ->
  densify -> re-probe trajectory at 1e-6, a forced rebalance bit for bit
  (the scores are tie-free), a starved pinned budget grown in the
  checkpoint, a resume that restores the budget without a probe call.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_dist_ranks as ranks  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro.core import tiling as jtl  # noqa: E402
from repro.core import train as jtr  # noqa: E402
from repro.core.cameras import orbital_rig, select  # noqa: E402
from repro.core.gaussians import Gaussians as JGaussians  # noqa: E402
from repro.core.gaussians import from_points  # noqa: E402
from repro.core.render import render_tiles  # noqa: E402
from repro.core.tiling import TileGrid as JGrid  # noqa: E402
from repro.data.isosurface import point_cloud_for  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import tiling as ttl  # noqa: E402
from repro_torch.core.gaussians import gaussians_from_numpy  # noqa: E402
from repro_torch.core.tiling import TileGrid  # noqa: E402
from repro_torch.core.train import init_opt  # noqa: E402

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")
N, P, RES, V, K = 256, 2, 32, 2, 16
GRID = (RES, RES, 8, 16)
T = (RES // 8) * (RES // 16)
CENTER = (0.5, 0.5, 0.5)
#: a 3-tile strip over a "part" axis of 2: padded sub-windows
PAD_GRID = (24, 8, 8, 8)
#: tag -> (shape, axes, the checks ``ranks.exchange_rank`` runs)
MESHES = {
    "m22": ((2, 2), ("part", "view"), ("fwd", "step", "starve", "pad",
                                       "wire")),
    "p4": ((4,), ("part",), ("fwd", "tau")),
    "pm22": ((2, 2), ("part", "model"), ("fwd",)),
}
#: the driver's train configs (EXDRIVER_SCRIPT)
DRV_T = dict(K=16, lambda_dssim=0.0, bg=0.0, view_batch=2, lr_colors=5e-2,
             max_new=64, densify_grad_thresh=1e-9)
DRV_X = dict(K=16, dense_k=16, lambda_dssim=0.0, bg=0.0, view_batch=2,
             lr_colors=5e-2, exchange=True)
FIT_D = dict(extent=1.0, grid=list(GRID))
RANKS_TIMEOUT_S = 240


def host(tree):
    return jax.tree.map(np.asarray, tree)


def save_scene(path, g_host, cams, gts, masks, grid):
    meta = {"width": cams.width, "height": cams.height, "grid": list(grid),
            "extent": 1.0}
    arrays = {f"g_{k}": np.asarray(v) for k, v in g_host._asdict().items()}
    np.savez(path, meta=json.dumps(meta), cam_view=np.asarray(cams.view),
             cam_fx=np.asarray(cams.fx), cam_fy=np.asarray(cams.fy),
             gts=np.asarray(gts), masks=np.asarray(masks), **arrays)


def scene_x():
    """EXCHANGE_SCRIPT's scene -> (g (2, N) host, per-partition gaussians,
    cams, grid).  Rows [N/2, 3N/4) of each partition take the geometry of
    rows [0, N/4) and keep their own colours: exact depth ties between the
    rows of different "part" shards (2 or 4 of them), which the (score,
    index) top-K breaks by table position -- so the received table's
    order shows in the tiles."""
    pts, cols = point_cloud_for("sphere_shell", 2 * N)
    g_all = from_points(jnp.asarray(pts[:2 * N]), jnp.asarray(cols[:2 * N]),
                        opacity=0.8)
    gb = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                      *[jax.tree.map(lambda x, i=i: x[i * N:(i + 1) * N],
                                     g_all) for i in range(P)])
    for f in ("means", "log_scales", "quats"):
        getattr(gb, f)[:, N // 2:3 * N // 4] = getattr(gb, f)[:, :N // 4]
    parts = [jax.tree.map(lambda x, i=i: jnp.asarray(x[i]), gb)
             for i in range(P)]
    cams = orbital_rig(V, CENTER, 1.6, width=RES, height=RES)
    return gb, parts, cams, JGrid(*GRID)


def scene_d():
    """EXDRIVER_SCRIPT's scene -> (g (1, 384) host, cams, gts, masks)."""
    pts, cols = point_cloud_for("sphere_shell", N)
    pts = pts[:N] + 1e-4 * np.random.default_rng(0).standard_normal(
        pts[:N].shape)
    cols = cols[:N]
    cams = orbital_rig(4, CENTER, 1.6, width=RES, height=RES)
    g_gt = from_points(jnp.asarray(pts), jnp.asarray(cols), opacity=0.95)
    gts = np.asarray(jpl.render_views(g_gt, cams, JGrid(*GRID), K=16,
                                      bg=0.0)[0])[None]
    g0 = host(from_points(jnp.asarray(pts), jnp.asarray(cols),
                          capacity=N + 128, opacity=0.7))
    return (jax.tree.map(lambda x: x[None], g0), cams, gts,
            np.ones((1, 4, RES, RES), bool))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank world starts first; the reference's one-device forward,
    step and renders run here meanwhile."""
    tmp = tmp_path_factory.mktemp("exchange")
    d = str(tmp)
    gb, parts, cams, grid = scene_x()
    save_scene(f"{d}/x.npz", gb, cams, np.zeros((P, V, RES, RES, 3), "f4"),
               np.ones((P, V, RES, RES), bool), grid)
    save_scene(f"{d}/d.npz", *scene_d(), grid)
    jobs = [("exchange_rank", (f"{d}/x.npz", d, tag, shape, axes, checks,
                               PAD_GRID))
            for tag, (shape, axes, checks) in MESHES.items()]

    def fit(tag, cfg_kw, fkw, ck=None):
        return ("fit_rank", (f"{d}/d.npz", d, cfg_kw, dict(FIT_D, **fkw),
                             None, ck, tag))
    lifecycle = dict(steps=6, densify_every=3, densify_from=0)
    jobs += [
        fit("drv_gather", DRV_T, lifecycle),
        fit("drv_ex", dict(DRV_T, exchange=True), lifecycle),
        fit("reb_plain", DRV_X, dict(steps=4)),
        fit("reb_forced", DRV_X, dict(steps=4, rebalance_every=2,
                                      rebalance_threshold=0.0)),
        fit("starved", dict(DRV_X, exchange_budget=1),
            dict(steps=3, ckpt_every=3), f"{d}/ck_starved"),
        fit("full", DRV_X, dict(steps=6)),
        fit("part", DRV_X, dict(steps=4, ckpt_every=4), f"{d}/ck_resume"),
        ("probe_counter_rank", (f"{d}/d.npz", d, DRV_X,
                                dict(FIT_D, steps=6, ckpt_every=4), None,
                                f"{d}/ck_resume", "resumed",
                                "probe_gs_exchange")),
    ]
    world = _torch_dist.Ranks(ranks.jobs_rank, (2, 2), tmp, jobs,
                              timeout=RANKS_TIMEOUT_S)
    try:
        out = {"dir": d, "gb": gb}
        mesh = jax.make_mesh((1, 1), ("part", "view"))
        gj = jax.tree.map(jnp.asarray, gb)
        cam = select(cams, jnp.arange(V))
        gt = jnp.zeros((V, P * T, 3, 8, 16))
        mask = jnp.ones((V, P * T, 8, 16), bool)
        for kname, kt in (("dense", None), ("tiered", (4, 8, K))):
            f = JD.make_gs_forward(mesh, grid, K=K, impl="ref", views=V,
                                   k_tiers=kt, return_tiles=True)
            loss, tiles = jax.jit(f)(gj, cam, gt, mask)
            out[f"ref_{kname}"] = (float(loss), np.asarray(tiles).reshape(
                V, P, T, 4, 8, 16))
        batch = {"gt_tiles": gt, "mask_tiles": mask, "cam": cam}
        for kname, kt, akw in (("dense", None, {}),
                               ("sorted", (4, 8, K),
                                dict(assign_impl="sorted", assign_budget=8))):
            cfg = jtr.GSTrainCfg(K=K, lr_colors=5e-2, impl="ref", **akw)
            step = JD.make_gs_train_step(mesh, cfg, grid, 1.0, impl="ref",
                                         views=V, k_tiers=kt)
            g1, _, loss = step(jax.tree.map(jnp.asarray, gb),
                               jtr.init_opt(gj), batch)
            out[f"ref_step_{kname}"] = (float(loss), host(g1))
        out["render"] = np.stack([np.stack([np.asarray(render_tiles(
            g, select(cams, v), grid, K=K, impl="ref")[0]) for g in parts])
            for v in range(V)])                      # (V, P, T, 4, th, tw)
    finally:
        world.join()
    return out


def records(runs, tag):
    world = int(np.prod(MESHES[tag][0]))
    return [np.load(os.path.join(runs["dir"], f"{tag}_rank{r}.npz"))
            for r in range(world)]


def replicated(runs, tag, key):
    """A value every rank of the mesh must hold alike."""
    got = [z[key] for z in records(runs, tag)]
    for x in got[1:]:
        np.testing.assert_array_equal(x, got[0], err_msg=key)
    return got[0]


def global_tiles(runs, tag, case):
    """The ranks' tiles of ``case`` laid out as (V, P, T, 4, th, tw): a
    gather rank holds its "model" strip of every tile of its views (the
    "part" ranks' copies must agree), an exchange rank sub-window ``pi``
    of its strip."""
    shape, axes, _ = MESHES[tag]
    size = dict(zip(axes, shape))
    Vl, Tl = V // size.get("view", 1), T // size.get("model", 1)
    sub = -(-Tl // size["part"])
    out = np.full((V, P, T, 4, 8, 16), np.nan, np.float32)
    for z in records(runs, tag):
        c = dict(zip(axes, z["coords"].tolist()))
        gather = "gather" in case
        width = Tl if gather else sub
        t0 = c.get("model", 0) * Tl + (0 if gather else c["part"] * sub)
        v0 = c.get("view", 0) * Vl
        block = out[v0:v0 + Vl, :, t0:t0 + width]
        t = z[f"{case}_px"].reshape(block.shape)
        if not np.isnan(block).all():
            np.testing.assert_array_equal(block, t)
        block[...] = t
    assert not np.isnan(out).any()
    return out


def losses_of(runs, tag, world=4):
    got = [np.load(os.path.join(runs["dir"], f"{tag}_losses{r}.npy"))
           for r in range(world)]
    for r in range(1, world):
        np.testing.assert_array_equal(got[r], got[0], err_msg=f"rank {r}")
    return got[0]


def assert_counters_zero(runs, tag, case):
    for z in records(runs, tag):
        for k in ("tiles", "assign", "exchange"):
            assert int(z[f"{case}_{k}"]) == 0, (case, k)
        if f"{case}_exchange_edges" in z:
            assert (z[f"{case}_exchange_edges"] == 0).all(), case


# ---------------------------------------------------------------------------
# host pieces against the reference (in process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t0,t_end", [(0, None), (5, None), (3, 7),
                                      ([0, 4], None), ([0, 3, 6], 8),
                                      ([2, 9], 9)])
def test_window_overlap_mask_matches_reference(t0, t_end):
    r = np.random.default_rng(3)
    shape = (2, 3, 200)
    mx = r.uniform(-20, 60, shape).astype("f4")
    my = r.uniform(-20, 60, shape).astype("f4")
    rad = r.uniform(0, 12, shape).astype("f4")
    valid = r.random(shape) < 0.8
    grid = (40, 36, 8, 16)
    n_local = 3
    want = np.asarray(jtl.window_overlap_mask(
        *(jnp.asarray(x) for x in (mx, my, rad, valid)), JGrid(*grid),
        t0=jnp.asarray(t0), n_local=n_local, t_end=t_end))
    got = ttl.window_overlap_mask(
        *(torch.from_numpy(x) for x in (mx, my, rad, valid)),
        TileGrid(*grid), t0=t0, n_local=n_local, t_end=t_end)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("bad,n", [(np.ones((2, 3)), None),
                                   (np.ones((2, 2)), 4),
                                   (np.ones((8, 8)), 4),
                                   (np.zeros((2, 2)), None),
                                   (np.full((2, 2), 1.5), None)])
def test_check_budget_matrix_refuses_as_reference(bad, n):
    with pytest.raises(ValueError) as want:
        JD.check_budget_matrix(bad, n)
    with pytest.raises(ValueError) as got:
        D.check_budget_matrix(bad, n)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        D.ExchangeSchedule(budget=np.ones((2, 3)))
    ok = D.check_budget_matrix(np.full((2, 2), 3.0), 2)
    assert ok.dtype == np.int64
    np.testing.assert_array_equal(ok, JD.check_budget_matrix(
        np.full((2, 2), 3.0), 2))


def test_window_assignment_matches_reference():
    """The reference's cases (uniform -> identity; heavy edges on one
    shift -> that derangement, the ladder 400+ rows cheaper) and seeded
    random matrices of 1 to 8 ranks, equal permutations."""
    n = 8
    sigma = np.roll(np.arange(n), 3)
    r = np.random.default_rng(0)
    B = r.integers(1, 8, (n, n))
    B[np.arange(n), sigma] = 500
    np.testing.assert_array_equal(D.window_assignment(B), sigma)
    np.testing.assert_array_equal(D.window_assignment(np.full((4, 4), 7)),
                                  np.arange(4))
    cases = [B, np.full((4, 4), 7), np.ones((1, 1))]
    cases += [r.integers(1, 300, (k, k)) for k in range(1, 9)
              for _ in range(3)]
    for Bm in cases:
        got = D.window_assignment(Bm)
        assert sorted(got.tolist()) == list(range(len(Bm)))
        np.testing.assert_array_equal(got, JD.window_assignment(Bm))


def _replay(mod):
    """``tests/test_distributed.py:656-742`` on one package's
    ExchangeSchedule: every return value and state snapshot, in order."""
    S = mod.ExchangeSchedule
    log = []

    def snap(es, *vals):
        log.append(([np.asarray(v).tolist() for v in vals], es.state_dict(),
                    repr(es), es.budget_key()))

    es = S()
    snap(es, es.note_overflow(5, 128))
    snap(es, es.probe_budget(121, 128), es.probe_budget(10, 512))
    snap(es, es.note_overflow(0, 512), es.note_overflow(7, 512),
         es.note_overflow(1, 512))
    es.budget = 512
    snap(es, es.note_overflow(3, 512))
    snap(S.from_state(es.state_dict()))
    snap(S(budget=64))
    em = S()
    snap(em, em.probe_budget(np.array([[40, 5], [90, 10]]), 512))
    ov = np.zeros((2, 2), np.int64)
    ov[0, 1] = 3
    snap(em, em.note_overflow(ov, 512), em.note_overflow(np.zeros((2, 2)),
                                                         512))
    sc = S.from_state(em.state_dict())
    snap(sc, sc.note_overflow(1, 512))
    snap(em, em.ensure(np.full((2, 2), 100), 512),
         em.ensure(np.full((2, 2), 1), 512))
    snap(S.from_state(em.state_dict()))
    sa = S(budget=40, slack=2.0, round_to=8, growth=3.0)
    snap(sa, sa.ensure(57, 100), sa.note_overflow(np.array([2]), 100),
         sa.probe_budget(np.array(7), 100))
    return log


def test_exchange_schedule_matches_reference():
    """Every method on the reference's test inputs: equal return values,
    ``state_dict`` JSON, repr and ``budget_key`` at each point."""
    got, want = _replay(D), _replay(JD)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert json.dumps(a[1]) == json.dumps(b[1])
        assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3]
    assert got[3][0] == [False] and got[6][1]["budget"] == [[64, 16],
                                                            [144, 16]]


class _DuckMesh:
    """What both packages' ``folded_tile_count`` and
    ``rebalance_partitions`` read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names, self.shape = tuple(axes), tuple(shape)
        self.devices = np.empty(shape)

    def axis_size(self, a):
        return dict(zip(self.axis_names, self.shape)).get(a, 1)


def _skewed(Pn=2, n=24, seed=0):
    """A host (g, opt) with every partition's live rows crowded onto its
    first shard, distinct values a row."""
    r = np.random.default_rng(seed)
    g = dict(means=r.random((Pn, n, 3)), log_scales=r.random((Pn, n, 3)),
             quats=r.random((Pn, n, 4)), opacity_logit=r.random((Pn, n)),
             colors=r.random((Pn, n, 3)))
    g = {k: v.astype("f4") for k, v in g.items()}
    active = np.zeros((Pn, n), bool)
    active[0, :9] = True
    active[1, 2:7] = active[1, 13:15] = True
    g.update(active=active, owner=np.zeros((Pn, n), "i4"))
    return g


@pytest.mark.parametrize("shape,axes", [((2, 2), ("part", "view")),
                                        ((4,), ("part",)),
                                        ((3,), ("part",))])
def test_rebalance_matches_reference(shape, axes):
    """The same permutation as the reference on the same host tree, dealt
    evenly (live counts a shard within one of each other), a pure
    permutation with the optimizer rows travelling along; under the
    threshold nothing moves."""
    m = _DuckMesh(shape, axes)
    gh = _skewed()
    tg = gaussians_from_numpy(gh, device="cpu")
    jg = JGaussians(**{k: jnp.asarray(v) for k, v in gh.items()})
    topt = init_opt(tg)
    topt = topt._replace(grad_accum=torch.rand(topt.grad_accum.shape))
    jopt = jtr.init_opt(jg)._replace(
        grad_accum=jnp.asarray(topt.grad_accum.numpy()))
    g2, o2, moved = D.rebalance_partitions(tg, topt, m, threshold=1.5)
    jg2, jo2, jmoved = JD.rebalance_partitions(jg, jopt, m, threshold=1.5)
    assert moved and jmoved
    for k in gh:
        np.testing.assert_array_equal(getattr(g2, k).numpy(),
                                      np.asarray(getattr(jg2, k)), err_msg=k)
    np.testing.assert_array_equal(o2.grad_accum.numpy(),
                                  np.asarray(jo2.grad_accum))
    n_data = m.axis_size("part")
    act = g2.active.numpy()
    live = act.reshape(2, n_data, -1).sum(-1)
    assert (live.max(-1) - live.min(-1) <= 1).all(), live
    for p in range(2):
        # the live rows keep their order; the accumulators travel with them
        np.testing.assert_array_equal(g2.means[p][act[p]].numpy(),
                                      gh["means"][p][gh["active"][p]])
        np.testing.assert_array_equal(
            o2.grad_accum[p][act[p]].numpy(),
            topt.grad_accum[p][torch.from_numpy(gh["active"][p])].numpy())
        assert sorted(g2.quats[p][:, 0].tolist()) == \
            sorted(gh["quats"][p][:, 0].tolist())
    g3, o3, moved3 = D.rebalance_partitions(g2, o2, m, threshold=1.5)
    assert not moved3 and g3 is g2 and o3 is o2


@pytest.mark.parametrize("shape,axes", [((2, 2), ("part", "view")),
                                        ((4,), ("part",)),
                                        ((2, 2), ("part", "model")),
                                        ((2, 3, 2), ("pod", "part",
                                                     "model"))])
def test_folded_tile_count_exchange_matches_reference(shape, axes):
    m = _DuckMesh(shape, axes)
    views = [2, 4] if "view" in axes else [None, 2, 4]
    for grid in (GRID, PAD_GRID, (1024, 1024, 8, 16)):
        for n_parts in (2, 4):
            for vb in views:
                for ex in (False, True):
                    assert D.folded_tile_count(
                        m, TileGrid(*grid), n_parts, vb, exchange=ex) == \
                        JD.folded_tile_count(m, JGrid(*grid), n_parts, vb,
                                             exchange=ex)


class _FakeMesh:
    """A ("part", "view") mesh of two "part" ranks, seen from rank 0,
    enough to build a forward (no collective runs before the checks)."""

    device = torch.device("cpu")
    axis_names = ("part", "view")

    def axis_size(self, a):
        return 2 if a == "part" else 1

    def index(self, a):
        return 0

    def group(self, *axes):
        return None


def test_exchange_refusals_match_reference():
    """The reference's two ``ValueError``s: a padded sub-window with
    ``return_tiles``, and the strip prefilter under the exchange; and a
    budget matrix of the wrong size."""
    with pytest.raises(ValueError, match="divide"):
        D.make_gs_forward(_FakeMesh(), TileGrid(*PAD_GRID), K=K, views=V,
                          exchange=True, return_tiles=True)
    with pytest.raises(ValueError, match="strip_budget"):
        D.make_gs_forward(_FakeMesh(), TileGrid(*GRID), K=K, views=V,
                          exchange=True, strip_budget=0.5)
    with pytest.raises(ValueError, match="refused"):
        D.make_gs_forward(_FakeMesh(), TileGrid(*GRID), K=K, views=V,
                          exchange=True, exchange_budget=np.ones((4, 4)))
    # both still build on a strip that divides, and without return_tiles
    D.make_gs_forward(_FakeMesh(), TileGrid(*PAD_GRID), K=K, views=V,
                      exchange=True)


# ---------------------------------------------------------------------------
# the forward and the step on gloo ranks
# ---------------------------------------------------------------------------


def test_exchange_probes(runs):
    """The scalar probe is the demand matrix's max; the budgets cover the
    demand (clamped at Nl) and every rank holds the same numbers."""
    for tag, (shape, axes, _) in MESHES.items():
        n_part = dict(zip(axes, shape))["part"]
        Nl = N // n_part
        raw, raw_m = (int(replicated(runs, tag, "raw")),
                      replicated(runs, tag, "raw_m"))
        E, B = int(replicated(runs, tag, "E")), replicated(runs, tag, "B")
        assert raw_m.shape == (n_part, n_part) and int(raw_m.max()) == raw
        assert 1 <= E <= Nl and E >= min(raw, Nl), (tag, E, raw)
        assert (B >= np.minimum(raw_m, Nl)).all(), (tag, B, raw_m)
        assert 0 < raw <= Nl


FWD_CASES = [(tag, kname, bname) for tag in MESHES
             for kname in ("dense", "tiered")
             for bname in ("none", "scalar", "matrix")]


@pytest.mark.parametrize("tag,kname,bname", FWD_CASES)
def test_exchange_forward_matches_gather(runs, tag, kname, bname):
    """Every sub-window's tiles equal the gather's at 1e-6, the loss at
    rtol 1e-6 / atol 1e-7; every counter 0; a matrix budget's in-step
    demand equals the host probe exactly."""
    case = f"{bname}_{kname}"
    np.testing.assert_allclose(global_tiles(runs, tag, case),
                               global_tiles(runs, tag, f"gather_{kname}"),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(replicated(runs, tag, f"{case}_loss")),
                               float(replicated(runs, tag,
                                                f"gather_{kname}_loss")),
                               rtol=1e-6, atol=1e-7)
    assert_counters_zero(runs, tag, case)
    if bname == "matrix":
        np.testing.assert_array_equal(
            replicated(runs, tag, f"{case}_exchange_demand"),
            replicated(runs, tag, "raw_m"))


@pytest.mark.parametrize("tag,kname", [(t, k) for t in ("m22", "p4")
                                       for k in ("dense", "tiered")])
def test_exchange_forward_matches_reference_one_device(runs, tag, kname):
    """The exchange's tiles at 1e-6 and loss at rtol 1e-5 / atol 1e-6
    against the reference's one-device forward."""
    loss, tiles = runs[f"ref_{kname}"]
    for bname in ("scalar", "matrix"):
        np.testing.assert_allclose(
            global_tiles(runs, tag, f"{bname}_{kname}"), tiles, rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(
            float(replicated(runs, tag, f"{bname}_{kname}_loss")), loss,
            rtol=1e-5, atol=1e-6)


def test_model_axis_matches_reference_render(runs):
    """("part", "model") 2x2, two partitions a rank: the exchange's
    sub-windows of each strip against the reference's single-device
    ``render_tiles`` at 1e-6."""
    for case in ("gather_dense", "scalar_dense", "matrix_tiered"):
        np.testing.assert_allclose(global_tiles(runs, "pm22", case),
                                   runs["render"], rtol=1e-6, atol=1e-6,
                                   err_msg=case)


def test_forced_window_assignment_matches_gather(runs):
    """("part",) x4 with each shard holding the rows of the next band (its
    heavy edges on a derangement): the probed matrix makes the ladder's
    window assignment leave the identity, and the loss still equals the
    gather's at 1e-6 with every counter 0."""
    B_tau = replicated(runs, "p4", "B_tau")
    tau = D.window_assignment(np.minimum(B_tau, N // 4))
    np.testing.assert_array_equal(tau, (np.arange(4) + 1) % 4)
    np.testing.assert_array_equal(tau, JD.window_assignment(
        np.minimum(B_tau, N // 4)))
    np.testing.assert_allclose(float(replicated(runs, "p4", "tau_loss")),
                               float(replicated(runs, "p4",
                                                "gather_tau_loss")),
                               rtol=1e-6, atol=1e-7)
    assert_counters_zero(runs, "p4", "tau")


def _stepped(runs, tag, case):
    z = records(runs, tag)[0]
    return {k: z[f"{case}_g_{k}"] for k in FIELDS}, \
        float(replicated(runs, tag, f"{case}_loss"))


@pytest.mark.parametrize("kname", ["dense", "sorted"])
def test_exchange_step_matches_gather_and_reference(runs, kname):
    """One train step on 2x2 (dense, and tiered + sorted assignment):
    trainables at 1e-6 and loss at 1e-6 / 1e-7 against the gather step,
    counters 0; trainables at 1e-6 and loss at rtol 1e-5 / atol 1e-6
    against the reference's one-device step."""
    pe, le = _stepped(runs, "m22", f"step_ex_{kname}")
    pg, lg = _stepped(runs, "m22", f"step_gather_{kname}")
    rl, rg = runs[f"ref_step_{kname}"]
    for k in FIELDS:
        np.testing.assert_allclose(pe[k], pg[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(pe[k], np.asarray(getattr(rg, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(le, lg, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(le, rl, rtol=1e-5, atol=1e-6)
    assert_counters_zero(runs, "m22", f"step_ex_{kname}")


def test_starved_budget_fires_its_counter(runs):
    """A scalar budget of 1 fires the counter with finite tiles, loss and
    stepped trainables; starving edge (0, 1) of the matrix fires only
    that edge, and the total counter is the edges' sum."""
    assert int(replicated(runs, "m22", "starved_exchange")) > 0
    assert np.isfinite(float(replicated(runs, "m22", "starved_loss")))
    assert np.isfinite(global_tiles(runs, "m22", "starved")).all()
    assert int(replicated(runs, "m22", "step_starved_exchange")) > 0
    ps, ls = _stepped(runs, "m22", "step_starved")
    assert np.isfinite(ls) and all(np.isfinite(v).all() for v in ps.values())
    edges = replicated(runs, "m22", "starved_edge_exchange_edges")
    assert edges[0, 1] > 0, edges
    others = edges.copy()
    others[0, 1] = 0
    assert (others == 0).all(), edges
    assert int(replicated(runs, "m22", "starved_edge_exchange")) == \
        int(edges.sum())
    assert np.isfinite(float(replicated(runs, "m22", "starved_edge_loss")))


def test_padded_strip_matches_gather(runs):
    """A 3-tile strip over "part" = 2 pads its sub-windows: the loss of
    the unbudgeted and the matrix exchange equals the gather's at 1e-6,
    no counter fires."""
    lg = float(replicated(runs, "m22", "pad_gather_loss"))
    for case in ("pad_none", "pad_matrix"):
        np.testing.assert_allclose(
            float(replicated(runs, "m22", f"{case}_loss")), lg, rtol=1e-6,
            atol=1e-7)
        assert_counters_zero(runs, "m22", case)


@pytest.mark.parametrize("pname", ["bf16", "split"])
@pytest.mark.parametrize("kname", ["dense", "tiered"])
def test_exchange_matches_gather_within_policy(runs, pname, kname):
    """The bf16 policy and the split tables: exchange tiles and loss equal
    the gather's under the same option at 1e-6; under bf16 one step's
    trainables too (BF16_SCRIPT's gate)."""
    np.testing.assert_allclose(
        global_tiles(runs, "m22", f"{pname}_ex_{kname}"),
        global_tiles(runs, "m22", f"{pname}_gather_{kname}"), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        float(replicated(runs, "m22", f"{pname}_ex_{kname}_loss")),
        float(replicated(runs, "m22", f"{pname}_gather_{kname}_loss")),
        rtol=1e-6, atol=1e-7)
    assert_counters_zero(runs, "m22", f"{pname}_ex_{kname}")
    if pname == "bf16":
        pe, le = _stepped(runs, "m22", f"step_bf16_ex_{kname}")
        pg, lg = _stepped(runs, "m22", f"step_bf16_gather_{kname}")
        for k in FIELDS:
            np.testing.assert_allclose(pe[k], pg[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(le, lg, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the driver against the port's gather driver
# ---------------------------------------------------------------------------


def test_driver_lifecycle_matches_gather(runs):
    """The tiered probe -> train -> densify -> re-probe trajectory under
    the exchange (a per-edge budget probed on 2x2, grown by ``ensure``
    after each densify) equals the gather driver's at 1e-6: losses and
    the gathered trainables."""
    le, lg = losses_of(runs, "drv_ex"), losses_of(runs, "drv_gather")
    assert len(le) == 6
    np.testing.assert_allclose(le, lg, rtol=1e-6, atol=1e-7)
    ze = np.load(os.path.join(runs["dir"], "drv_ex.npz"))
    zg = np.load(os.path.join(runs["dir"], "drv_gather.npz"))
    for k in FIELDS + ("active",):
        np.testing.assert_allclose(ze[f"g_{k}"], zg[f"g_{k}"], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert int(zg["g_active"].sum()) > N        # densify added splats


def test_forced_rebalance_keeps_losses_bit_identical(runs):
    """Dealing the rows anew every 2 steps (threshold 0) moves no loss
    bit: with tie-free scores the top-K does not depend on row order."""
    plain = losses_of(runs, "reb_plain")
    np.testing.assert_array_equal(losses_of(runs, "reb_forced"), plain)
    z = np.load(os.path.join(runs["dir"], "reb_forced.npz"))
    live = z["g_active"].reshape(1, 2, -1).sum(-1)
    assert abs(int(live[0, 0]) - int(live[0, 1])) <= 1, live


def _manifests(root):
    return sorted(glob.glob(os.path.join(root, "step_*", "manifest.json")))


def test_starved_pinned_budget_grows_into_checkpoint(runs):
    """A pinned budget of 1 fires the counter and grows geometrically; the
    grown budget is what the checkpoint's ``extra["exchange"]`` holds, in
    the reference's keys."""
    assert np.isfinite(losses_of(runs, "starved")).all()
    with open(_manifests(os.path.join(runs["dir"], "ck_starved"))[-1]) as f:
        state = json.load(f)["extra"]["exchange"]
    assert state["budget"] > 1, state
    assert state.keys() == JD.ExchangeSchedule().state_dict().keys()
    assert state == JD.ExchangeSchedule.from_state(state).state_dict()


def test_resume_restores_budget_without_probe(runs):
    """A resume from step 4 restores the probed budget from the
    checkpoint and calls ``probe_gs_exchange`` on no rank; its tail equals
    the uninterrupted run's at 1e-6."""
    full = losses_of(runs, "full")
    resumed = losses_of(runs, "resumed")
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, full[4:], rtol=1e-6, atol=1e-7)
    for r in range(4):
        calls = np.load(os.path.join(runs["dir"], f"resumed_probes{r}.npy"))
        assert int(calls) == 0, (r, calls)
    with open(_manifests(os.path.join(runs["dir"], "ck_resume"))[0]) as f:
        state = json.load(f)["extra"]["exchange"]
    assert np.ndim(state["budget"]) == 2      # per edge on 2 "part" ranks
