"""Port parity: the distributed trainer's "pod" and "model" mesh axes and
the strip prefilter (``strip_budget < 1``) on gloo ranks.

The ranks run in spawned processes (``_torch_dist``: torch only, a
``file://`` rendezvous, a join deadline and a 60 s collective timeout);
the JAX reference runs in this process on one CPU device.  The scene is
the reference's own 2x2x2 one (``tests/test_distributed.py`` SCRIPT): two
partitions, the two halves of a 512-point sphere_shell cloud at opacity
0.8, 32x32 images in 8x16 tiles (T = 8), K = 16; the targets are the
reference's renders + 0.05, every pixel masked in.  Meshes: ("pod",
"part", "model") 1x1x1, 2x1x1, 1x1x2, 2x1x2 and 2x2x1, and ("part",
"model", "view") 1x2x2.  On 1x1x2 a rank holds both partitions (Pl = 2)
and half the tiles of each (n_model = 2).  Gates, each with its reason:

- every forward variant's tiles against the reference's single-device
  ``render_tiles`` at 1e-6 and its loss against ``tile_l1_dssim_loss`` at
  rtol 1e-4 / atol 1e-5 (the reference's own gates,
  ``tests/test_distributed.py:98-101``);
- every mesh's forwards and its one train step against the port's
  1x1x1 at 1e-6: the losses, the tiles, the overflow counters and every
  stepped field, Adam moment and densify statistic (float32 sums in
  another order: the strips' and pods' partials are added by a
  collective);
- ``strip_budget=127/128`` against 1.0 at 1e-6 (its compacted table keeps
  every splat of the strip);
- ``fit_partitions`` on a pod = 2 mesh with two densify events against
  the 1x1x1 run at 1e-6, and checkpoints across the two meshes both ways:
  the resumed tail equals the uninterrupted one at 1e-6;
- ``folded_tile_count`` against the reference's function; the mesh's
  groups; the production meshes' refusal of a world of another size.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_dist_ranks as ranks  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core.cameras import orbital_rig, select  # noqa: E402
from repro.core.gaussians import from_points  # noqa: E402
from repro.core.masking import tile_l1_dssim_loss  # noqa: E402
from repro.core.render import render_tiles  # noqa: E402
from repro.core.tiling import TileGrid as JGrid  # noqa: E402
from repro.core.tiling import untile_image  # noqa: E402
from repro.data.isosurface import point_cloud_for  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.tiling import TileGrid  # noqa: E402

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")
N, P, RES, V, K = 256, 2, 32, 4, 16
GRID = (RES, RES, 8, 16)
T = (RES // 8) * (RES // 16)
PPM = ("pod", "part", "model")
#: tag -> (shape, axes); "111" is the port's own single-rank oracle
MESHES = {
    "111": ((1, 1, 1), PPM),
    "211": ((2, 1, 1), PPM),
    "112": ((1, 1, 2), PPM),
    "212": ((2, 1, 2), PPM),
    "221": ((2, 2, 1), PPM),
    "122v": ((1, 2, 2), ("part", "model", "view")),
}
#: the fit runs: the trainer's tiered defaults at the scene's K, two views
#: a step, densify after steps 2 and 4
FIT_KW = dict(K=K, view_batch=2, lr_colors=5e-2, max_new=32,
              densify_grad_thresh=1e-9)
FIT = dict(steps=4, extent=1.0, densify_every=2, densify_from=1,
           grid=list(GRID), ckpt_every=2)
#: each spawned world's join deadline (its jobs take a few seconds alone)
RANKS_TIMEOUT_S = 240


def _world(tag):
    return int(np.prod(MESHES[tag][0]))


def _save_scene(path, g, cams, gts, masks):
    meta = {"width": cams.width, "height": cams.height, "grid": list(GRID),
            "extent": 1.0}
    arrays = {f"g_{k}": np.asarray(v) for k, v in g._asdict().items()}
    np.savez(path, meta=json.dumps(meta), cam_view=np.asarray(cams.view),
             cam_fx=np.asarray(cams.fx), cam_fy=np.asarray(cams.fy),
             gts=gts, masks=masks, **arrays)


def _stack(parts):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *parts)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the module: the rank worlds start first (in spawned
    processes) and the reference renders here meanwhile; the checkpoint
    crossings run once both uninterrupted fits are done."""
    tmp = tmp_path_factory.mktemp("axes")
    d = str(tmp)
    pts, cols = point_cloud_for("sphere_shell", P * N)
    pts, cols = jnp.asarray(pts[:P * N]), jnp.asarray(cols[:P * N])
    cams = orbital_rig(V, (0.5, 0.5, 0.5), 1.6, width=RES, height=RES)
    grid = JGrid(*GRID)
    halves = [(pts[i * N:(i + 1) * N], cols[i * N:(i + 1) * N])
              for i in range(P)]
    parts = [from_points(p, c, opacity=0.8) for p, c in halves]
    ref = np.stack([np.stack([np.asarray(render_tiles(
        g, select(cams, v), grid, K=K, impl="ref")[0]) for g in parts])
        for v in range(V)])                           # (V, P, T, 4, th, tw)
    gt = np.clip(ref[:, :, :, :3] + 0.05, 0, 1)
    pad = np.concatenate([gt, np.zeros_like(gt[:, :, :, :1])], 3)
    gts = np.stack([[np.asarray(untile_image(jnp.asarray(pad[v, p]), grid))
                     [..., :3] for v in range(V)] for p in range(P)])
    masks = np.ones((P, V, RES, RES), bool)
    _save_scene(f"{d}/fwd.npz", _stack(parts), cams, gts, masks)
    fit_parts = [from_points(p, c, capacity=N + 64, opacity=0.7)
                 for p, c in halves]
    _save_scene(f"{d}/fit.npz", _stack(fit_parts), cams, gts, masks)

    def axes_job(*tags):
        return ("axes_rank", (f"{d}/fwd.npz", d,
                              [(t,) + MESHES[t] for t in tags]))

    def fit_job(tag, ckpt):
        return ("fit_rank", (f"{d}/fit.npz", d, FIT_KW, FIT, None, ckpt, tag))

    started = [
        _torch_dist.Ranks(ranks.jobs_rank, (1, 1, 1), tmp, [
            axes_job("111"), fit_job("fit11", f"{d}/ck11"),
            ("production_mesh_rank", (f"{d}/production1.json",))],
            timeout=RANKS_TIMEOUT_S, axes=PPM),
        _torch_dist.Ranks(ranks.jobs_rank, (2, 1, 1), tmp, [
            axes_job("211", "112"), fit_job("fitpod", f"{d}/ckpod")],
            timeout=RANKS_TIMEOUT_S, axes=PPM),
        _torch_dist.Ranks(ranks.jobs_rank, (2, 1, 2), tmp, [
            axes_job("212", "221", "122v"),
            ("production_mesh_rank", (f"{d}/production4.json",))],
            timeout=RANKS_TIMEOUT_S, axes=PPM),
    ]
    try:
        out = {"dir": d, "ref": ref, "gt": gt, "g": _stack(parts),
               "fit_g": _stack(fit_parts)}
        flat = lambda x: jnp.asarray(x.reshape((P * T, 3, 8, 16)))  # noqa
        out["ref_loss"] = {
            views: float(np.mean([tile_l1_dssim_loss(
                flat(ref[v][:, :, :3]), flat(gt[v]),
                jnp.ones((P * T, 8, 16), bool), win_size=7)
                for v in range(views)])) for views in (1, 2)}
        # the checkpoints cross meshes once both fits have written them
        for r in started[:2]:
            r.join()
        for src, dst in (("ck11", "ck11_to_pod"), ("ckpod", "ckpod_to_11")):
            shutil.copytree(f"{d}/{src}/step_000000002",
                            f"{d}/{dst}/step_000000002")
        started += [
            _torch_dist.Ranks(ranks.jobs_rank, (1, 1, 1), tmp, [
                fit_job("pod_to_11", f"{d}/ckpod_to_11")],
                timeout=RANKS_TIMEOUT_S, axes=PPM),
            _torch_dist.Ranks(ranks.jobs_rank, (2, 1, 1), tmp, [
                fit_job("11_to_pod", f"{d}/ck11_to_pod")],
                timeout=RANKS_TIMEOUT_S, axes=PPM),
        ]
    finally:
        errors = []
        for r in started:
            try:
                r.join()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
    if errors:
        raise errors[0]
    return out


def rank_records(runs, tag):
    return [np.load(os.path.join(runs["dir"], f"{tag}_rank{r}.npz"))
            for r in range(_world(tag))]


def global_tiles(runs, tag, name):
    """The ranks' tiles laid out as (views, P, T, 4, th, tw); the "part"
    ranks' redundant copies of a block must be equal."""
    shape, axes = MESHES[tag]
    size = dict(zip(axes, shape))
    nv = 1 if name == "single" else 2
    Pl, Tl, Vl = P // size.get("pod", 1), T // size.get("model", 1), \
        nv // size.get("view", 1)
    out = np.full((nv, P, T, 4, 8, 16), np.nan, np.float32)
    for z in rank_records(runs, tag):
        c = dict(zip(axes, z["coords"].tolist()))
        t = z[f"{name}_tiles"].reshape(Vl, Pl, Tl, 4, 8, 16)
        v0, p0, t0 = (c.get(a, 0) * n for a, n in (("view", Vl),
                                                     ("pod", Pl),
                                                     ("model", Tl)))
        block = out[v0:v0 + Vl, p0:p0 + Pl, t0:t0 + Tl]
        if not np.isnan(block).all():
            np.testing.assert_array_equal(block, t)
        block[...] = t
    assert not np.isnan(out).any()
    return out


def losses(runs, tag, key):
    got = [float(z[key]) for z in rank_records(runs, tag)]
    assert all(x == got[0] for x in got), got
    return got[0]


#: (mesh, forward variant): a mesh with a "view" axis runs batched views
FORWARDS = [(tag, name) for tag in MESHES for name, views, _ in
            ranks.FWD_VARIANTS if views or "view" not in MESHES[tag][1]]


@pytest.mark.parametrize("tag,name", FORWARDS)
def test_forward_matches_single_device(runs, tag, name):
    """Tiles at 1e-6 and loss at rtol 1e-4 against the reference's
    single-device renders (two views batched, or view 0 alone), and at
    1e-6 against the port's 1x1x1; overflow 0."""
    nv = 1 if name == "single" else 2
    tiles = global_tiles(runs, tag, name)
    np.testing.assert_allclose(tiles, runs["ref"][:nv], rtol=1e-6, atol=1e-6)
    loss = losses(runs, tag, f"{name}_loss")
    np.testing.assert_allclose(loss, runs["ref_loss"][nv], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tiles, global_tiles(runs, "111", name),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loss, losses(runs, "111", f"{name}_loss"),
                               rtol=1e-6, atol=1e-6)
    for z in rank_records(runs, tag):
        assert z[f"{name}_overflow"].tolist() == [0, 0]


@pytest.mark.parametrize("tag", list(MESHES))
def test_strip_budget_127_128_is_exact(runs, tag):
    """The strip prefilter at 127/128 (N = 256 slots: the budget rounds up
    to all of them) against the unfiltered forward at 1e-6."""
    np.testing.assert_allclose(global_tiles(runs, tag, "strip"),
                               global_tiles(runs, tag, "dense"), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(losses(runs, tag, "strip_loss"),
                               losses(runs, tag, "dense_loss"), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("tag", [t for t in MESHES if t != "111"])
def test_train_step_matches_one_rank(runs, tag):
    """One tiered train step (two views) against the port's 1x1x1 step:
    loss, every updated field and Adam moment and grad_accum at 1e-6,
    grad_count and the overflow counters exactly."""
    np.testing.assert_allclose(losses(runs, tag, "step_loss"),
                               losses(runs, "111", "step_loss"), rtol=1e-6,
                               atol=1e-6)
    for z in rank_records(runs, tag):
        assert z["step_overflow"].tolist() == [0, 0]
    got, want = (np.load(os.path.join(runs["dir"], f"{t}_state.npz"))
                 for t in (tag, "111"))
    for k in FIELDS:
        for pre in ("g", "m", "v"):
            np.testing.assert_allclose(got[f"{pre}_{k}"], want[f"{pre}_{k}"],
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{pre}_{k}")
    np.testing.assert_array_equal(got["grad_count"], want["grad_count"])
    np.testing.assert_allclose(got["grad_accum"], want["grad_accum"],
                               rtol=1e-6, atol=1e-6)
    assert int(got["step"]) == 1


@pytest.mark.parametrize("tag", list(MESHES))
def test_mesh_groups(runs, tag):
    """Each collective's group: the ranks that share every coordinate
    outside its axes (row-major rank order)."""
    shape, axes = MESHES[tag]
    coords = [np.unravel_index(r, shape) for r in range(_world(tag))]
    for r, z in enumerate(rank_records(runs, tag)):
        assert tuple(z["coords"]) == tuple(coords[r])
        for key in [k for k in z.files if k.startswith("group_")]:
            inside = key[len("group_"):].split("+")
            want = [q for q in range(_world(tag))
                    if all(coords[q][i] == coords[r][i]
                           for i, a in enumerate(axes) if a not in inside)]
            assert z[key].tolist() == want, (r, key)


def _fit(runs, tag, world):
    z = np.load(os.path.join(runs["dir"], f"{tag}.npz"))
    got = [np.load(os.path.join(runs["dir"], f"{tag}_losses{r}.npy"))
           for r in range(world)]
    for r in range(1, world):
        np.testing.assert_array_equal(got[r], got[0])
    return z, got[0]


def _assert_states_close(a, b):
    for k in FIELDS:
        np.testing.assert_allclose(a[f"g_{k}"], b[f"g_{k}"], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in ("g_active", "g_owner", "grad_count", "step"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fit_partitions_pod_mesh_matches_one_rank(runs):
    """``fit_partitions`` on ("pod", "part", "model") 2x1x1, one partition
    a rank, 4 steps with densify events after steps 2 and 4, against the
    1x1x1 run: losses and state at 1e-6, the same live slots.  (The tier
    caps differ: each covers its rank's own folded tile domain.)"""
    pod, lp = _fit(runs, "fitpod", 2)
    one, l1 = _fit(runs, "fit11", 1)
    assert len(lp) == 4
    np.testing.assert_allclose(lp, l1, rtol=1e-6, atol=1e-6)
    _assert_states_close(pod, one)
    assert int(one["g_active"].sum()) > int(runs["fit_g"].active.sum())


@pytest.mark.parametrize("tag,world,oracle", [("pod_to_11", 1, "fitpod"),
                                              ("11_to_pod", 2, "fit11")])
def test_checkpoint_crosses_pod_mesh(runs, tag, world, oracle):
    """The global step-2 checkpoint of one mesh resumes on the other
    (pod = 2 -> 1x1x1 and back) onto the uninterrupted run's last two
    losses and final state at 1e-6."""
    z, got = _fit(runs, tag, world)
    want, wl = _fit(runs, oracle, 3 - world)
    assert len(got) == 2
    np.testing.assert_allclose(got, wl[2:], rtol=1e-6, atol=1e-6)
    _assert_states_close(z, want)


class _DuckMesh:
    """What both packages' ``folded_tile_count`` read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names, self.shape = tuple(axes), tuple(shape)
        self.devices = np.empty(shape)

    def axis_size(self, a):
        return dict(zip(self.axis_names, self.shape)).get(a, 1)


@pytest.mark.parametrize("tag", list(MESHES))
def test_folded_tile_count_matches_reference(tag):
    m = _DuckMesh(*MESHES[tag])
    views = [2, 4] + ([None] if "view" not in MESHES[tag][1] else [])
    for grid in (GRID, (1024, 1024, 8, 16)):
        for n_parts in (2, 4):
            for vb in views:
                assert D.folded_tile_count(m, TileGrid(*grid), n_parts,
                                           vb) == \
                    JD.folded_tile_count(m, JGrid(*grid), n_parts, vb)


def test_production_meshes_refuse_another_world(runs):
    """``make_production_mesh`` needs 256 (512 multi-pod) ranks and raises
    on 1 and 4; ``single_device_mesh`` is the (1, 1) ("data", "model")
    mesh of a world of one, "data" resolving as the gaussian axis."""
    seen = {}
    for world in (1, 4):
        with open(os.path.join(runs["dir"], f"production{world}.json")) as f:
            seen[world] = json.load(f)
        assert "256 ranks" in seen[world]["multi_pod=False"]
        assert "512 ranks" in seen[world]["multi_pod=True"]
    assert "single" not in seen[4]
    assert seen[1]["single"] == [["data", "model"], [1, 1],
                                 [None, "data", "model", None]]
