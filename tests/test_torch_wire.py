"""Port parity of the distributed trainer's wire options: the bf16 wire
tables (``dtype_policy="bf16"``), ``gather_mode="split"`` and gradient
compression (``optim/compress.py``, ``grad_compress``), against the JAX
package.

The ranks run in spawned processes (``_torch_dist``: torch only, a
``file://`` rendezvous, a join deadline and a 60 s collective timeout);
the JAX reference runs in this process on one CPU device.  Scene A: two
partitions of a 256-point sphere_shell cloud at opacity 0.8 (the second
holds the points in reverse order), 32x32 images in 8x16 tiles, two
views, the reference's renders of the cloud at opacity 0.95 as targets.
Scene C: ``tests/test_compress.py``'s driver scene (64 points, 16x16 in
8x8 tiles, two views, K = 8).  Gates, each with its reason:

- ``compress_grads`` bit for bit on the reference's ``_tree`` shapes: the
  same float32 arithmetic, round half to even in both packages;
- the wire tables against the reference's formulas on its own
  projection: float32 columns at 1e-6 of each column's magnitude (the
  projections differ by one rounding, ROADMAP queue 3), bfloat16 entries
  at most one of them one bfloat16 step apart (that rounding can cross a
  bfloat16 rounding boundary; measured: none);
- the one-rank forward against the reference's on a one-device mesh:
  tiles and loss within 2^-8 = 3.9e-3, the most one bfloat16 step (2^-8
  relative) of one rgb, alpha or conic entry moves a pixel (a pixel is
  linear in rgb and alpha with coefficients <= 1, and alpha * sigma *
  exp(-sigma) <= 1/e bounds the conic's); measured 3.0e-7;
- the one-rank uncompressed step against the reference's on a
  one-device mesh: first moments within 2^-8 of their field's largest,
  second moments within twice that, stepped fields at 1e-6 (its
  docstring; measured 3.2e-7 and 3.0e-8);
- split against the f32 tables on the port's own output: the reference's
  image gate (``tests/test_distributed.py:113-119``: 5e-2 max, 2e-3 mean,
  loss 2e-3);
- meshes: one step on ("part", "view") 2x2 and ("part",) 2x1 against 1x1
  at 1e-6 under each option, as the reference holds its own meshes
  (BF16-MESH-PARITY, ``tests/test_distributed.py:1224-1231``); the int8
  cases compare the Adam moments and the residual, which carry the
  scale: a per-rank scale instead of the global one fails them;
  ("pod", "part", "model") 2x1x2 at ``strip_budget`` 0.9 against its
  1x1x1, under split + bf16 and under int8 (not both together: each
  strip sums its bf16 table gradients apart, which rounds differently
  from one rank's sum, and int8 turns such a rounding into a whole
  quantum -- measured 13 of 1536 moments off by 1.4e-5);
- the compressed step: the port's compressed gradients equal the
  reference's ``compress_grads`` of the port's own gradients bit for bit;
  its loss equals the uncompressed step's at 1e-7 (compression comes
  after the forward, BF16-COMPRESS, ``tests/test_distributed.py:1267``),
  the reference's at the step tests' rtol 1e-5 / atol 1e-6, and every
  trainable is within 2 lr of the reference's compressed step (the first
  Adam step moves a component by at most lr);
- ``fit_partitions`` under int8 (``tests/test_compress.py:133``): losses
  at the driver tests' rtol 1e-5 / atol 1e-6 against the reference's run,
  a warm start drops the residual (equal to a fresh warm start bit for
  bit), a disk resume keeps it (and diverges), a densify event zeroes it,
  and (g, opt, err) checkpoints cross both ways;
- the CLI with ``--dtype-policy bf16 --grad-compress int8 --smoke`` at
  world sizes 1 and 4: it trains, resumes, and a resume under another
  policy exits naming both.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_dist_ranks as ranks  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core import dtypes as jdt  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro.core import train as jtr  # noqa: E402
from repro.core.cameras import orbital_rig, select  # noqa: E402
from repro.core.gaussians import from_points  # noqa: E402
from repro.core.projection import project as j_project  # noqa: E402
from repro.core.tiling import TileGrid as JGrid  # noqa: E402
from repro.data.isosurface import point_cloud_for  # noqa: E402
from repro.optim.compress import compress_grads as j_compress  # noqa: E402
from repro.runtime import CheckpointManager as JCkpt  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import dtypes as tdt  # noqa: E402
from repro_torch.core import train as ttr  # noqa: E402
from repro_torch.core.cameras import Camera  # noqa: E402
from repro_torch.core.gaussians import gaussians_from_numpy  # noqa: E402
from repro_torch.core.projection import project as t_project  # noqa: E402
from repro_torch.core.tiling import TileGrid  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.optim.compress import compress_grads  # noqa: E402
from repro_torch.runtime.checkpoint import (CheckpointManager,  # noqa: E402
                                            unshaped_like)

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")
N, RES, V, K = 256, 32, 2, 16
GRID = (RES, RES, 8, 16)
CENTER = (0.5, 0.5, 0.5)
#: scene C (tests/test_compress.py ``_scene``)
NC, RES_C = 64, 16
GRID_C = (RES_C, RES_C, 8, 8)
#: the one-step meshes' train config, and each option under test
STEP_KW = dict(K=K, view_batch=2, lr_colors=5e-2)
MESH_VARIANTS = {
    "bf16_dense": dict(dtype_policy="bf16", k_tiers=None),
    "bf16": dict(dtype_policy="bf16"),
    "split_dense": dict(gather_mode="split", k_tiers=None),
    "split": dict(gather_mode="split"),
    "int8": dict(grad_compress="int8"),
    "bf16c": dict(grad_compress="bf16"),
}
#: the ("pod", "part", "model") cases: split + bf16, and int8 (f32 tables:
#: bf16 table gradients summed per strip round differently from one
#: rank's, and int8 turns such a rounding into a whole quantum)
POD_VARIANTS = {
    "wire": dict(STEP_KW, gather_mode="split", dtype_policy="bf16",
                 strip_budget=0.9),
    "int8": dict(STEP_KW, strip_budget=0.9, grad_compress="int8"),
}
#: scene C's int8 driver config (tests/test_compress.py:148)
INT8_KW = dict(K=8, lambda_dssim=0.0, bg=0.0, view_batch=1, lr_colors=5e-2,
               grad_compress="int8")
FIT_C = dict(extent=1.0, grid=list(GRID_C))
#: one bfloat16 step of one rgb / alpha / conic entry (module docstring)
FLIP_GATE = 2.0 ** -8
RANKS_TIMEOUT_S = 300


def host(tree):
    return jax.tree.map(np.asarray, tree)


def save_scene(path, g_host, cams, gts, masks, grid, extent=1.0):
    meta = {"width": cams.width, "height": cams.height, "grid": list(grid),
            "extent": extent}
    arrays = {f"g_{k}": np.asarray(v) for k, v in g_host._asdict().items()}
    np.savez(path, meta=json.dumps(meta), cam_view=np.asarray(cams.view),
             cam_fx=np.asarray(cams.fx), cam_fy=np.asarray(cams.fy),
             gts=np.asarray(gts), masks=np.asarray(masks), **arrays)


def scene_a():
    """-> (g (2, N) host, cams, gts (2, V, H, W, 3), masks, grid)."""
    pts, cols = point_cloud_for("sphere_shell", N)
    pts, cols = jnp.asarray(pts[:N]), jnp.asarray(cols[:N])
    g = host(from_points(pts, cols, opacity=0.8))
    g = type(g)(*(np.stack([f, f[::-1]]) for f in g))
    cams = orbital_rig(V, CENTER, 1.6, width=RES, height=RES)
    grid = JGrid(*GRID)
    img = np.asarray(jpl.render_views(from_points(pts, cols, opacity=0.95),
                                      cams, grid, K=K, bg=0.0)[0])
    return g, cams, np.stack([img, img]), np.ones((2, V, RES, RES), bool), \
        grid


def scene_c():
    """``tests/test_compress.py``'s ``_scene`` as host arrays."""
    pts, cols = point_cloud_for("sphere_shell", NC)
    pts, cols = jnp.asarray(pts[:NC]), jnp.asarray(cols[:NC])
    cams = orbital_rig(V, CENTER, 1.6, width=RES_C, height=RES_C)
    grid = JGrid(*GRID_C)
    gts = np.asarray(jpl.render_views(from_points(pts, cols, opacity=0.95),
                                      cams, grid, K=8, bg=0.0)[0])
    g0 = host(from_points(pts, cols, opacity=0.7))
    return (jax.tree.map(lambda x: x[None], g0), cams, gts[None],
            np.ones((1, V, RES_C, RES_C), bool), grid)


def _mk(d, name):
    path = os.path.join(d, name)
    os.makedirs(path, exist_ok=True)
    return path


def _wait_for(path, starts, timeout=RANKS_TIMEOUT_S):
    """Wait until ``path`` exists; raise early if a rank set failed."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        for r in starts:
            if any(p.exitcode not in (None, 0) for p in r.procs):
                r.join()
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.2)


def ref_fit(cfg, scene, **kw):
    """The reference's ``fit_partitions`` on scene C, from fresh device
    arrays (it donates them) -> losses."""
    gb, cams, gts, masks, grid = scene
    _, _, losses = JD.fit_partitions(
        jax.tree.map(jnp.asarray, gb), cams, jnp.asarray(gts),
        jnp.asarray(masks), cfg, mesh=jax.make_mesh((1, 1), ("part", "view")),
        extent=1.0, grid=grid, key=jax.random.PRNGKey(7),
        schedule=cfg.tier_schedule(), impl="ref", **kw)
    return np.asarray(losses)


def cli_argv(ckpt_dir, steps, policy="bf16"):
    return ["--gs", "--smoke", "--device", "cpu", "--dtype-policy", policy,
            "--grad-compress", "int8", "--ckpt-dir", ckpt_dir, "--steps",
            str(steps)]


def cli_jobs(d, world):
    root = _mk(d, f"cli{world}")
    log = os.path.join(d, f"cli{world}_log")
    return [("cli_rc_rank", (cli_argv(root, 2), f"{log}_a")),
            ("cli_rc_rank", (cli_argv(root, 3), f"{log}_b")),
            ("cli_rc_rank", (cli_argv(root, 4, "f32"), f"{log}_c"))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank run of the module; they start first and the reference
    runs here meanwhile."""
    tmp = tmp_path_factory.mktemp("wire")
    d = str(tmp)
    g, cams, gts, masks, grid = scene_a()
    save_scene(f"{d}/a.npz", g, cams, gts, masks, grid)
    sc = scene_c()
    save_scene(f"{d}/c.npz", *sc)

    def steps(tag):
        return [("wire_step_rank", (f"{d}/a.npz", d, f"{tag}_{name}",
                                    dict(STEP_KW, **kw), 2, "cfg"))
                for name, kw in MESH_VARIANTS.items()]

    def pod(tag, shape):
        return [("wire_step_rank", (f"{d}/a.npz", d, f"{tag}_{name}", kw, 2,
                                    "cfg", shape, ("pod", "part", "model")))
                for name, kw in POD_VARIANTS.items()]

    fit = lambda tag, fkw, ck=None, warm=None: ("fit_rank", (  # noqa: E731
        f"{d}/c.npz", d, INT8_KW, dict(FIT_C, **fkw), None, ck, tag, None,
        warm))
    ck_port = f"{d}/ck_port"
    jobs1 = [fit("p3", dict(steps=3, ckpt_every=3), ck_port),
             fit("p6", dict(steps=6), ck_port),
             fit("warm", dict(steps=6), warm=(ck_port, 3, True)),
             fit("fresh", dict(steps=6), warm=(ck_port, 3, False)),
             fit("dens", dict(steps=3, ckpt_every=3, densify_every=3,
                              densify_from=0), f"{d}/ck_dens")]
    jobs1 += steps("m11") + pod("pod111", (1, 1, 1)) + cli_jobs(d, 1)
    jobs4 = steps("m22") + pod("pod212", (2, 1, 2)) + cli_jobs(d, 4)
    started = [
        _torch_dist.Ranks(ranks.jobs_rank, (1, 1), tmp, jobs1,
                          timeout=RANKS_TIMEOUT_S),
        _torch_dist.Ranks(ranks.jobs_rank, (2, 2), tmp, jobs4,
                          timeout=RANKS_TIMEOUT_S),
    ]
    try:
        out = {"dir": d}
        cfg = jtr.GSTrainCfg(impl="ref", **INT8_KW)
        # the reference's int8 run, checkpointed at step 3 with its
        # residual; the port resumes that checkpoint on 2 ranks
        out["ref3"] = ref_fit(cfg, sc, steps=3,
                              ckpt=JCkpt(f"{d}/ck_ref", keep=0),
                              ckpt_every=3)
        shutil.copytree(f"{d}/ck_ref/step_000000003",
                        f"{d}/ck_ref2/step_000000003")
        jobs2 = steps("m21") + [fit("from_ref", dict(steps=6),
                                    f"{d}/ck_ref2")]
        started.append(_torch_dist.Ranks(
            ranks.jobs_rank, (2,), tmp, jobs2, timeout=RANKS_TIMEOUT_S,
            axes=("part",)))
        out["ref_tail"] = ref_fit(cfg, sc, steps=6,
                                  ckpt=JCkpt(f"{d}/ck_ref", keep=0))
        # the port's step-3 checkpoint, resumed by the reference
        _wait_for(f"{ck_port}/step_000000003/_COMPLETE", started)
        shutil.copytree(f"{ck_port}/step_000000003",
                        f"{d}/ck_port_ref/step_000000003")
        out["ref_from_port"] = ref_fit(
            cfg, sc, steps=6, ckpt=JCkpt(f"{d}/ck_port_ref", keep=0))
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


def load(runs, name):
    return np.load(os.path.join(runs["dir"], name))


def losses_of(runs, tag, world):
    got = [np.load(os.path.join(runs["dir"], f"{tag}_losses{r}.npy"))
           for r in range(world)]
    for r in range(1, world):
        np.testing.assert_array_equal(got[r], got[0], err_msg=f"rank {r}")
    return got[0]


@pytest.fixture(scope="module")
def world1():
    """A world-1 gloo group in this process and its 1x1 ("part", "view")
    mesh (every group None: no collective runs)."""
    mesh_mod.init_distributed("cpu")
    try:
        yield mesh_mod.make_mesh((1, 1), ("part", "view"))
    finally:
        mesh_mod.destroy_distributed()


# ---------------------------------------------------------------------------
# optim/compress.py and the dtype helpers (in process)
# ---------------------------------------------------------------------------


def _tree(seed=0):
    """The reference's ``_tree`` (tests/test_compress.py:30) as host
    arrays: (33, 7) and 1e-3 * (128,) normals."""
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    return {"a": np.asarray(jax.random.normal(ka, (33, 7), jnp.float32)),
            "b": np.asarray(1e-3 * jax.random.normal(kb, (128,),
                                                     jnp.float32))}


def _port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_compress_none_is_identity():
    g = _port(_tree())
    out, err, ratio = compress_grads(g, "none")
    assert out is g and err is None and ratio == 1.0


def test_compress_bf16_matches_reference():
    t = _tree()
    want, werr, wr = j_compress({k: jnp.asarray(v) for k, v in t.items()},
                                "bf16")
    got, err, ratio = compress_grads(_port(t), "bf16")
    assert (ratio, err) == (wr, werr) == (2.0, None)
    for k in t:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_compress_int8_matches_reference_over_three_steps():
    """Three steps with the residual carried, each on a new gradient: the
    dequantised gradients and the residuals bit for bit; a None residual
    starts from zeros."""
    jerr, terr = None, None
    for step in range(3):
        t = _tree(step)
        want, jerr, wr = j_compress({k: jnp.asarray(v) for k, v in t.items()},
                                    "int8", jerr)
        got, terr, ratio = compress_grads(_port(t), "int8", terr)
        assert ratio == wr == 4.0
        for k in t:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))
        assert max(float(e.abs().max()) for e in terr.values()) > 0
    zeros = {k: torch.zeros_like(v) for k, v in _port(_tree()).items()}
    a, ea, _ = compress_grads(_port(_tree()), "int8", None)
    b, eb, _ = compress_grads(_port(_tree()), "int8", zeros)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(ea[k], eb[k])


def test_compress_unknown_mode_raises():
    with pytest.raises(ValueError):
        compress_grads(_port(_tree()), "fp4")


def test_table_dtype_and_to_f32_match_reference():
    for pol in ("f32", "bf16"):
        assert str(tdt.table_dtype(pol)).split(".")[-1] == \
            jnp.dtype(jdt.table_dtype(pol)).name
    with pytest.raises(ValueError):
        tdt.table_dtype("fp8")
    x = np.linspace(-3, 3, 35, dtype=np.float32).reshape(5, 7) / 3
    tree = (torch.from_numpy(x), {"m": torch.from_numpy(x > 0)})
    assert tdt.cast_tables(tree, "f32") is tree
    assert tdt.to_f32(tree) is tree
    cast = tdt.cast_tables(tree, "bf16")
    assert cast[0].dtype == torch.bfloat16 and cast[1]["m"].dtype == \
        torch.bool
    back = tdt.to_f32(cast)
    want = jdt.to_f32(jdt.cast_tables(jnp.asarray(x), "bf16"))
    assert back[0].dtype == torch.float32
    np.testing.assert_array_equal(back[0].numpy(), np.asarray(want))
    assert back[1]["m"] is cast[1]["m"]


# ---------------------------------------------------------------------------
# the forward on one rank against the reference's one-device mesh
# ---------------------------------------------------------------------------


class _OneRank:
    """A mesh of one rank (every group None: no collective runs)."""

    device = torch.device("cpu")
    axis_names = ("part", "view")

    def axis_size(self, a):
        return 1

    def index(self, a):
        return 0

    def group(self, *axes):
        return None


@pytest.fixture(scope="module")
def fwd_inputs():
    g, cams, gts, masks, grid = scene_a()
    gt_t, mask_t = JD._tile_view_batches(jnp.asarray(gts), jnp.asarray(masks),
                                         grid)
    cam_b = select(cams, jnp.arange(V))
    tcam = Camera(torch.from_numpy(np.array(cam_b.view)),
                  torch.from_numpy(np.array(cam_b.fx)),
                  torch.from_numpy(np.array(cam_b.fy)), RES, RES)
    tg = gaussians_from_numpy(g._asdict(), device="cpu")
    return dict(jg=jax.tree.map(jnp.asarray, g), cam=cam_b, gt=gt_t,
                mask=mask_t, tg=tg, tcam=tcam,
                tgt=torch.from_numpy(np.asarray(gt_t)),
                tmask=torch.from_numpy(np.asarray(mask_t)))


def _ref_tables(g1, cam, mode):
    """The reference's wire tables (``make_gs_forward``'s formulas) on its
    own projection of one partition, before the policy cast."""
    s = j_project(g1, cam)
    if mode == "split":
        a, b, c = s.cov2d[..., 0], s.cov2d[..., 1], s.cov2d[..., 2]
        det = jnp.maximum(a * c - b * b, 1e-12)
        alpha = jnp.where(s.valid, s.alpha, 0.0)
        geo = jnp.stack([s.mean2d[..., 0], s.mean2d[..., 1],
                         jnp.where(s.valid, s.radius, 0.0), s.depth], -1)
        rest = jnp.stack([c / det, -b / det, a / det, s.rgb[..., 0],
                          s.rgb[..., 1], s.rgb[..., 2], alpha,
                          jnp.zeros_like(alpha)], -1).astype(jnp.bfloat16)
        return geo, rest
    from repro.core.tiling import splat_features
    aux = jnp.stack([s.radius, s.depth, s.valid.astype(jnp.float32)], -1)
    return splat_features(s), aux


def _as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.to(torch.float32).numpy()


@pytest.mark.parametrize("mode", ["f32", "split"])
@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_wire_tables_match_reference(fwd_inputs, mode, policy):
    """``wire_tables`` (cast by the policy) against the reference's tables:
    dtypes and widths equal, so 76 / 38 / 32 / 24 bytes a splat; float32
    columns at 1e-6 of each column's magnitude; bfloat16 entries: at most
    one differs, by one bfloat16 step."""
    g1 = jax.tree.map(lambda x: x[0], fwd_inputs["jg"])
    cam = select(fwd_inputs["cam"], 0)
    want = jdt.cast_tables(_ref_tables(g1, cam, mode), policy)
    tg = gaussians_from_numpy({k: np.asarray(v) for k, v in
                               g1._asdict().items()}, device="cpu")
    tcam = Camera(*(f[0] for f in fwd_inputs["tcam"][:3]), RES, RES)
    got = tdt.cast_tables(D.wire_tables(t_project(tg, tcam), mode), policy)
    expect = {("f32", "f32"): 76, ("f32", "bf16"): 38,
              ("split", "f32"): 32, ("split", "bf16"): 24}[(mode, policy)]
    assert D.wire_bytes_per_splat(got) == expect
    flips = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name
        x, y = _as_f32(a), _as_f32(b)
        if a.dtype == torch.float32:
            scale = np.maximum(np.abs(y).max(axis=tuple(range(y.ndim - 1))),
                               1.0)
            assert (np.abs(x - y) <= 1e-6 * scale).all()
        else:
            diff = x != y
            flips += int(diff.sum())
            # one bfloat16 step: 2^-7 of the value's binade
            step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(y), 1e-30)))
                           - 7)
            assert (np.abs(x - y)[diff] <= step[diff]).all()
    assert flips <= 1, flips


FWD_VARIANTS = [
    dict(gather_mode="split"), dict(dtype_policy="bf16"),
    dict(gather_mode="split", dtype_policy="bf16")]


@pytest.mark.parametrize("strip", [1.0, 127 / 128])
@pytest.mark.parametrize("k_tiers", [None, (4, 8, K)])
@pytest.mark.parametrize("opts", FWD_VARIANTS,
                         ids=["split", "bf16", "split_bf16"])
def test_forward_matches_reference(fwd_inputs, opts, k_tiers, strip):
    """One rank's forward (two partitions, two views) against the
    reference's ``make_gs_forward`` on a one-device mesh, dense and
    tiered, with and without the strip prefilter: tiles and loss within
    one bfloat16 flip's bound (module docstring; measured 3.0e-7).  Split
    under the f32 policy also holds the reference's image gate against the
    f32 tables."""
    f = fwd_inputs
    kw = dict(opts, k_tiers=k_tiers, strip_budget=strip)
    jf = JD.make_gs_forward(jax.make_mesh((1, 1), ("part", "view")),
                            JGrid(*GRID), K=K, impl="ref", views=V,
                            return_tiles=True, **kw)
    jl, jt = jax.jit(jf)(f["jg"], f["cam"], f["gt"], f["mask"])
    port = lambda **o: D.make_gs_forward(  # noqa: E731
        _OneRank(), TileGrid(*GRID), K=K, impl="ref", views=V,
        return_tiles=True, **o)(f["tg"], f["tcam"], f["tgt"], f["tmask"])
    tl, tt = port(**kw)
    err = np.abs(tt.detach().numpy() - np.asarray(jt))
    assert err.max() <= FLIP_GATE, err.max()
    assert abs(float(tl) - float(jl)) <= FLIP_GATE
    if opts.get("dtype_policy", "f32") == "f32":
        bl, bt = port(k_tiers=k_tiers, strip_budget=strip)
        e = np.abs(tt[:, :, :3].detach().numpy() - bt[:, :, :3].numpy())
        assert e.max() < 5e-2 and e.mean() < 2e-3, (e.max(), e.mean())
        assert abs(float(tl) - float(bl)) < 2e-3


@pytest.mark.parametrize("mode", ["f32", "split"])
def test_bf16_rounded_geometry_sorted_equals_dense(fwd_inputs, mode):
    """The bf16 policy rounds depth and radius too, so many splats tie on
    depth; on that policy-rounded geometry the sorted assignment equals
    the dense sweep, and both the reference's, bit for bit (the (score,
    index) tie-break), and the forward's tiles are identical under
    either impl."""
    f = fwd_inputs
    splats = D._project_rows(f["tg"], f["tcam"], True)
    tabs = tdt.to_f32(tdt.cast_tables(D.wire_tables(splats, mode), "bf16"))
    tabs = [t.detach().reshape((-1,) + tuple(t.shape[2:])) for t in tabs]
    if mode == "split":
        mean, radius, depth = tabs[0][..., 0:2], tabs[0][..., 2], \
            tabs[0][..., 3]
        valid = radius > 0
    else:
        mean, radius, depth = tabs[0][..., 0:2], tabs[1][..., 0], \
            tabs[1][..., 1]
        valid = tabs[1][..., 2] > 0.5
    d = depth[valid]
    assert d.numel() - torch.unique(d).numel() > 50     # real ties
    grid = TileGrid(*GRID)
    from repro_torch.core.tiling import tile_bounds
    lo, hi = tile_bounds(grid, "cpu")
    got = {impl: D._assign_tiles_local(mean, radius, depth, valid, lo, hi,
                                       K=K, block=64, impl=impl, grid=grid,
                                       tile_budget=grid.n_tiles)
           for impl in ("dense", "sorted")}
    jlo, jhi = [jnp.asarray(x.numpy()) for x in (lo, hi)]
    want = JD._assign_tiles_local(*(jnp.asarray(x.numpy()) for x in
                                    (mean, radius, depth, valid)),
                                  jlo, jhi, K=K, block=64, impl="dense",
                                  grid=JGrid(*GRID))
    for impl, out in got.items():
        for a, b in zip(out, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=impl)
    tiles = [D.make_gs_forward(
        _OneRank(), grid, K=K, impl="ref", views=V, return_tiles=True,
        gather_mode=mode, dtype_policy="bf16", assign_impl=impl,
        assign_budget=grid.n_tiles)(f["tg"], f["tcam"], f["tgt"],
                                    f["tmask"])[1]
        for impl in ("dense", "sorted")]
    assert torch.equal(tiles[0], tiles[1])


def test_unknown_gather_mode_raises():
    with pytest.raises(ValueError, match="gather_mode"):
        D.make_gs_forward(_OneRank(), TileGrid(*GRID), K=K,
                          gather_mode="bf16")


# ---------------------------------------------------------------------------
# the compressed step (in process, a world-1 group)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compressed_step_matches_reference(world1, fwd_inputs, mode,
                                           monkeypatch):
    """One compressed step on 1x1: the port's compressed gradients equal
    the reference's ``compress_grads`` of the port's own summed gradients
    bit for bit; the loss equals the uncompressed step's at 1e-7 and the
    reference's compressed step's at rtol 1e-5 / atol 1e-6; every
    trainable within 2 lr of the reference's."""
    f = fwd_inputs
    seen = []
    real = D.compress_grads

    def spy(grads, m, err=None, **kw):
        out = real(grads, m, err, **kw)
        seen.append(({k: v.clone() for k, v in grads.items()},
                     None if err is None else dict(err), out))
        return out

    monkeypatch.setattr(D, "compress_grads", spy)
    cfg = ttr.GSTrainCfg(grad_compress=mode, **STEP_KW)
    grid = TileGrid(*GRID)
    batch = {"gt_tiles": f["tgt"], "mask_tiles": f["tmask"], "cam": f["tcam"]}
    opt = ttr.init_opt(f["tg"])
    err0 = D.zero_err(f["tg"], mode)
    g1, _, err1, loss = D.make_gs_train_step(
        world1, cfg, grid, 1.0, impl="ref", views=V)(f["tg"], opt, err0,
                                                       batch)
    assert (err1 is None) == (mode == "bf16")
    _, _, loss0 = D.make_gs_train_step(
        world1, ttr.GSTrainCfg(**STEP_KW), grid, 1.0, impl="ref",
        views=V)(f["tg"], opt, batch)
    assert abs(float(loss) - float(loss0)) <= 1e-7
    (grads, e_in, (out, e_out, _)), = seen
    want, werr, _ = j_compress({k: jnp.asarray(v.numpy())
                                for k, v in grads.items()}, mode,
                               None if e_in is None else
                               {k: jnp.asarray(v.numpy())
                                for k, v in e_in.items()})
    for k in FIELDS:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
        if mode == "int8":
            np.testing.assert_array_equal(e_out[k].numpy(),
                                          np.asarray(werr[k]))
    # the reference's compressed step on a one-device mesh
    jcfg = jtr.GSTrainCfg(impl="ref", grad_compress=mode, **STEP_KW)
    jstep = JD.make_gs_train_step(jax.make_mesh((1, 1), ("part", "view")),
                                  jcfg, JGrid(*GRID), 1.0, impl="ref",
                                  views=V)
    jg = jax.tree.map(jnp.asarray, host(f["jg"]))
    jerr = None if mode == "bf16" else jax.tree.map(
        lambda x: jnp.zeros_like(x, jnp.float32), jg.trainable())
    rg, _, _, rl = jstep(jg, jtr.init_opt(jg), jerr,
                         {"gt_tiles": f["gt"], "mask_tiles": f["mask"],
                          "cam": f["cam"]})
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5, atol=1e-6)
    lrs = ttr.group_lrs(cfg, 1.0)
    for k in FIELDS:
        d = np.abs(getattr(g1, k).numpy() - np.asarray(getattr(rg, k)))
        assert d.max() <= 2 * lrs[k] + 1e-6, (k, d.max())


@pytest.mark.parametrize("strip", [1.0, 127 / 128])
@pytest.mark.parametrize("k_tiers", [None, (4, 8, K)])
@pytest.mark.parametrize("opts", FWD_VARIANTS,
                         ids=["split", "bf16", "split_bf16"])
def test_wire_step_matches_reference(world1, fwd_inputs, opts, k_tiers,
                                     strip):
    """One uncompressed step on 1x1 against the reference's step on a
    one-device mesh, dense and tiered, with and without the strip
    prefilter.  It holds the gradients through the wire tables: the
    means' through split's gathered ``geo`` (a detached copy gives them
    none) and every field's through the bf16 tables' per-tile gather and
    its transpose.  Gates: the loss at the forward's one-flip bound; each
    first moment (m = (1 - b1) grad) within 2^-8 of its field's largest,
    one bfloat16 step of the largest term; each second moment (grad^2)
    within twice that; the densify statistics as m; the stepped fields at
    the driver tests' 1e-6.  Measured on every case: loss 2.6e-8, moments
    3.2e-7 of their field's largest, fields 3.0e-8.  For scale, the same
    step's means moment under the f32 tables differs from split's by 5.5e-3
    of its largest and from the bf16 policy's by 1.0."""
    f = fwd_inputs
    kw = dict(STEP_KW, k_tiers=k_tiers, strip_budget=strip, **opts)
    batch = {"gt_tiles": f["tgt"], "mask_tiles": f["tmask"], "cam": f["tcam"]}
    g1, opt1, loss = D.make_gs_train_step(
        world1, ttr.GSTrainCfg(**kw), TileGrid(*GRID), 1.0, impl="ref",
        views=V)(f["tg"], ttr.init_opt(f["tg"]), batch)
    jstep = JD.make_gs_train_step(jax.make_mesh((1, 1), ("part", "view")),
                                  jtr.GSTrainCfg(impl="ref", **kw),
                                  JGrid(*GRID), 1.0, impl="ref", views=V)
    jg = jax.tree.map(jnp.asarray, host(f["jg"]))
    rg, ropt, rl = jstep(jg, jtr.init_opt(jg),
                         {"gt_tiles": f["gt"], "mask_tiles": f["mask"],
                          "cam": f["cam"]})
    assert abs(float(loss) - float(rl)) <= FLIP_GATE
    assert np.abs(np.asarray(ropt.m["means"])).max() > 0
    for k in FIELDS:
        for got, want, gate in ((opt1.m[k], ropt.m[k], FLIP_GATE),
                                (opt1.v[k], ropt.v[k], 2 * FLIP_GATE)):
            want = np.asarray(want)
            d = np.abs(got.numpy() - want)
            assert d.max() <= gate * np.abs(want).max(), (k, d.max())
        np.testing.assert_allclose(getattr(g1, k).numpy(),
                                   np.asarray(getattr(rg, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    want = np.asarray(ropt.grad_accum)
    assert np.abs(opt1.grad_accum.numpy() - want).max() <= \
        FLIP_GATE * want.max()
    np.testing.assert_array_equal(opt1.grad_count.numpy(),
                                  np.asarray(ropt.grad_count))


# ---------------------------------------------------------------------------
# meshes on gloo ranks
# ---------------------------------------------------------------------------


def _state_close(got, want, keys, atol=1e-6):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=atol,
                                   err_msg=k)


def _step_keys(z):
    return [k for k in z.files if k.startswith(("g_", "m_", "v_", "e_"))
            and z[k].dtype.kind == "f"] + ["grad_accum", "grad_count"]


@pytest.mark.parametrize("variant", list(MESH_VARIANTS))
@pytest.mark.parametrize("mesh", ["m22", "m21"])
def test_meshes_equal_one_rank(runs, mesh, variant):
    """One step on ("part", "view") 2x2 and ("part",) 2x1 against 1x1 at
    1e-6: every rank's loss, every stepped field, Adam moment, densify
    statistic and (int8) residual."""
    world = 4 if mesh == "m22" else 2
    want = load(runs, f"m11_{variant}.npz")
    got = load(runs, f"{mesh}_{variant}.npz")
    wl = float(load(runs, f"m11_{variant}_loss0.npy")[0])
    for r in range(world):
        gl = float(load(runs, f"{mesh}_{variant}_loss{r}.npy")[0])
        np.testing.assert_allclose(gl, wl, rtol=1e-6, atol=1e-7)
    keys = _step_keys(want)
    assert set(keys) <= set(got.files)
    if variant == "int8":
        assert any(k.startswith("e_") for k in keys)
        assert max(np.abs(want[k]).max() for k in keys
                   if k.startswith("e_")) > 0
    _state_close(got, want, keys)


@pytest.mark.parametrize("variant", list(POD_VARIANTS))
def test_pod_model_mesh_equals_one_rank(runs, variant):
    """("pod", "part", "model") 2x1x2 at ``strip_budget`` 0.9 against its
    1x1x1: under int8 (its scale a MAX over "pod") every stepped field,
    moment, statistic and residual at 1e-6; under split + bf16 the losses
    and the stepped fields at 1e-6 (what BF16-MESH-PARITY holds), and the
    moments and ``grad_accum`` within 2^-6 of each one's largest
    magnitude: each "model" strip sums its bf16 table rows' gradients
    apart, rounding at 2^-9 of its partial sums, and components of
    opposite sign cancel (measured at most 9.4e-3, ``v_colors``)."""
    want = load(runs, f"pod111_{variant}.npz")
    got = load(runs, f"pod212_{variant}.npz")
    wl = float(load(runs, f"pod111_{variant}_loss0.npy")[0])
    for r in range(4):
        np.testing.assert_allclose(
            float(load(runs, f"pod212_{variant}_loss{r}.npy")[0]), wl,
            rtol=1e-6, atol=1e-7)
    keys = _step_keys(want)
    if variant == "int8":
        _state_close(got, want, keys)
        return
    _state_close(got, want, [k for k in keys if k.startswith("g_")])
    for k in keys:
        if not k.startswith("g_"):
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 2.0 ** -6 * scale, k


# ---------------------------------------------------------------------------
# fit_partitions under int8 (tests/test_compress.py:133)
# ---------------------------------------------------------------------------


def _err_like():
    """A shape-free (g, opt, err) template."""
    g = gaussians_from_numpy({k: np.zeros((1, 4) + v.shape[2:], v.dtype)
                              for k, v in scene_c()[0]._asdict().items()},
                             device="cpu")
    return unshaped_like((g, ttr.init_opt(g), D.zero_err(g, "int8")))


def _saved_err(path, step):
    (_, _, err), extra = CheckpointManager(path).restore(step, _err_like(),
                                                         device="cpu")
    assert extra["grad_compress"] == "int8"
    return max(float(e.abs().max()) for e in err.values())


def test_fit_int8_matches_reference(runs):
    """The port's int8 run (3 steps, then a disk resume to 6) against the
    reference's, at the driver tests' rtol 1e-5 / atol 1e-6."""
    got = np.concatenate([losses_of(runs, "p3", 1), losses_of(runs, "p6", 1)])
    want = np.concatenate([runs["ref3"], runs["ref_tail"]])
    assert len(got) == 6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fit_int8_warm_start_drops_residual(runs):
    """A warm start handed (g, opt, err) equals one handed (g, opt) bit
    for bit (the residual is dropped); the disk resume keeps it: the same
    first loss, then another trajectory."""
    assert _saved_err(f"{runs['dir']}/ck_port", 3) > 0
    warm, fresh = losses_of(runs, "warm", 1), losses_of(runs, "fresh", 1)
    np.testing.assert_array_equal(warm, fresh)
    for k in FIELDS:
        np.testing.assert_array_equal(load(runs, "warm.npz")[f"g_{k}"],
                                      load(runs, "fresh.npz")[f"g_{k}"])
    resumed = losses_of(runs, "p6", 1)
    assert resumed[0] == warm[0]
    assert list(resumed[1:]) != list(warm[1:]), (resumed, warm)


def test_fit_int8_densify_zeroes_residual(runs):
    """A densify event after the last step leaves a zero residual in the
    checkpoint; the same steps without it leave a nonzero one."""
    assert _saved_err(f"{runs['dir']}/ck_dens", 3) == 0.0
    assert _saved_err(f"{runs['dir']}/ck_port", 3) > 0.0
    np.testing.assert_array_equal(losses_of(runs, "dens", 1),
                                  losses_of(runs, "p3", 1))


def test_reference_int8_checkpoint_resumes_on_two_ranks(runs):
    """The reference's (g, opt, err) checkpoint (1x1, step 3) resumes on a
    2x1 ("part", "view") mesh onto the reference's own tail."""
    got = losses_of(runs, "from_ref", 2)
    assert len(got) == 3
    np.testing.assert_allclose(got, runs["ref_tail"], rtol=1e-5, atol=1e-6)


def test_port_int8_checkpoint_resumes_in_reference(runs):
    """The port's (g, opt, err) checkpoint resumes in the reference's
    ``fit_partitions`` onto the port's own tail."""
    got = runs["ref_from_port"]
    assert len(got) == 3
    np.testing.assert_allclose(got, losses_of(runs, "p6", 1), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_out(runs, world, run, rank=0):
    base = os.path.join(runs["dir"], f"cli{world}_log_{run}")
    with open(f"{base}.{rank}") as f:
        text = f.read()
    with open(f"{base}.rc{rank}") as f:
        return int(f.read()), text


@pytest.mark.parametrize("world", [1, 4])
def test_cli_bf16_int8_trains_and_resumes(runs, world):
    """``--dtype-policy bf16 --grad-compress int8 --smoke``: two steps,
    then a resume to three; the checkpoints carry the policy and a
    nonzero residual."""
    rc_a, first = _cli_out(runs, world, "a")
    rc_b, second = _cli_out(runs, world, "b")
    assert rc_a == rc_b == 0, (first, second)
    mesh = "mesh=1x1" if world == 1 else "mesh=2x2"
    for text in (first, second):
        assert "dtype=bf16 grad-compress=int8" in text, text
        assert mesh in text and "PSNR" in text, text
    assert "resuming from checkpoint step 2" in second
    assert "trained steps 2->3 (1 ran" in second
    root = os.path.join(runs["dir"], f"cli{world}")
    ck = CheckpointManager(root)
    assert ck.all_steps() == [2, 3]
    assert ck.manifest_extra(3)["dtype_policy"] == "bf16"
    assert _saved_err(root, 3) > 0


@pytest.mark.parametrize("world", [1, 4])
def test_cli_resume_under_another_policy_exits(runs, world):
    """A resume with ``--dtype-policy f32`` from the bf16 checkpoints
    exits 2 on every rank, naming both policies."""
    for r in range(world):
        rc, text = _cli_out(runs, world, "c", r)
        assert rc == 2, text
        if r == 0:
            assert "dtype_policy='bf16'" in text and "'f32'" in text, text
