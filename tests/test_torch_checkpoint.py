"""Port parity: checkpoints, resume, serving from a checkpoint, and ``ft``.

A checkpoint is the second bridge between the packages (the first is
``gaussians_from_numpy``): a tree either package writes restores in the
other, leaf for leaf and bit for bit, with the same file names and the same
manifest (``treedef``, ``n_leaves``, ``leaves``, ``extra``; only ``time``
differs).  Gates, each with its reason:
- checkpoints, deltas and int8 cold quantization: bit-identical (the same
  numpy arithmetic on the same arrays);
- a port run resumed from a checkpoint the REFERENCE wrote: losses at 1e-4
  relative of the reference's uninterrupted run, the ``fit_partition``
  parity gate (tests/test_torch_train.py), with the reference's split
  noise injected; the live mask equal;
- a port run resumed from its own checkpoint: losses at 1e-6 relative of
  the uninterrupted port run (the same arithmetic on the same state; the
  reference's own resume test pins 1e-6), zero initial tier probes;
- serving a reference-written merged checkpoint: images at 1e-5 (the
  serving parity gate, tests/test_torch_serving.py), every decision and
  the telemetry equal.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cameras as jc  # noqa: E402
from repro.core import gaussians as jg  # noqa: E402
from repro.core import serving as js  # noqa: E402
from repro.core import train as jtr  # noqa: E402
from repro.core.tiling import TileGrid as JGrid  # noqa: E402
from repro.data.isosurface import point_cloud_for  # noqa: E402
from repro.launch import serve_gs as j_serve_gs  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro_torch.core import cameras as tc  # noqa: E402
from repro_torch.core import serving as ts  # noqa: E402
from repro_torch.core import train as ttr  # noqa: E402
from repro_torch.core.gaussians import Gaussians, gaussians_from_numpy  # noqa: E402
from repro_torch.core.tiling import TierSchedule, TileGrid  # noqa: E402
from repro_torch.launch import serve_gs  # noqa: E402
from repro_torch.runtime import checkpoint as tck  # noqa: E402
from repro_torch.runtime import ft  # noqa: E402

RES = 32
DIMS = (RES, RES, 8, 16)
CENTER = (0.5, 0.5, 0.5)
IMG_TOL = 1e-5
FIELDS = ("means", "log_scales", "quats", "opacity_logit", "colors")


def to_port(g):
    return gaussians_from_numpy({k: np.asarray(v) for k, v in
                                 g._asdict().items()}, device="cpu")


def j_model(seed=0, n=128, capacity=192):
    """A reference model with free slots and perturbed fields, so every
    leaf holds distinct values."""
    pts, cols = point_cloud_for("sphere_shell", n, seed=seed)
    g = jg.from_points(jnp.asarray(pts[:n]), jnp.asarray(cols[:n]),
                       capacity=capacity, opacity=0.7)
    r = np.random.default_rng(seed)
    return g._replace(
        quats=jnp.asarray(r.normal(size=(capacity, 4)).astype(np.float32)),
        opacity_logit=g.opacity_logit + jnp.asarray(
            r.normal(size=capacity).astype(np.float32)),
        owner=jnp.asarray(r.integers(0, 3, capacity).astype(np.int32)))


def opt_trees(g, seed=0):
    """The same optimizer state in both packages, every moment distinct
    (so a leaf-order slip shows)."""
    r = np.random.default_rng(seed + 100)
    m = {k: r.normal(size=np.shape(getattr(g, k))).astype(np.float32)
         for k in FIELDS}
    v = {k: r.uniform(size=np.shape(getattr(g, k))).astype(np.float32)
         for k in FIELDS}
    acc = r.uniform(size=g.means.shape[0]).astype(np.float32)
    cnt = np.floor(r.uniform(0, 5, size=g.means.shape[0])).astype(np.float32)
    jopt = jtr.GSOptState({k: jnp.asarray(x) for k, x in m.items()},
                          {k: jnp.asarray(x) for k, x in v.items()},
                          jnp.int32(7), jnp.asarray(acc), jnp.asarray(cnt))
    # the port's moments in ITS insertion order (Gaussians.trainable())
    topt = ttr.GSOptState({k: torch.from_numpy(m[k]) for k in FIELDS},
                          {k: torch.from_numpy(v[k]) for k in FIELDS},
                          torch.tensor(7, dtype=torch.int32),
                          torch.from_numpy(acc), torch.from_numpy(cnt))
    return jopt, topt


def trees(kind, seed=0):
    """(reference tree, port tree) holding the same values."""
    g = j_model(seed)
    if kind == "gaussians":
        return g, to_port(g)
    if kind == "g_opt":
        jopt, topt = opt_trees(g, seed)
        return (g, jopt), (to_port(g), topt)
    w = np.random.default_rng(seed).normal(size=(8, 16)).astype(np.float32)
    jtree = {"w": jnp.asarray(w), "nested": {
        "b": jnp.arange(10, dtype=jnp.int32), "s": jnp.float32(3.5)}}
    ttree = {"w": torch.from_numpy(w), "nested": {
        "s": torch.tensor(3.5), "b": torch.arange(10, dtype=torch.int32)}}
    return jtree, ttree


def host_leaves(tree):
    """A tree's leaves as host arrays, in ``jax.tree.leaves`` order (the
    reference's flattening, applied to either package's tree)."""
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in jax.tree.leaves(tree)]


def assert_bit_equal(a, b):
    la, lb = host_leaves(a), host_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


# ---------------------------------------------------------------------------
# The on-disk format, both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partition", [None, 1])
@pytest.mark.parametrize("kind", ["gaussians", "g_opt", "dict"])
def test_checkpoint_is_byte_compatible_both_ways(tmp_path, kind, partition):
    """Each package writes the same tree: the same files, the same bytes in
    every leaf file, the same manifest (treedef string included); each
    restores the other's, bit for bit, into its own containers."""
    jtree, ttree = trees(kind)
    jm = jck.CheckpointManager(str(tmp_path / "ref"))
    tm = tck.CheckpointManager(str(tmp_path / "port"))
    extra = {"note": "hi", "schedule": {"ladder": [1, 2]}}
    jd = jm.save(3, jtree, partition=partition, extra=extra)
    td = tm.save(3, ttree, partition=partition, extra=extra)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        if name.endswith(".npy"):
            with open(os.path.join(jd, name), "rb") as a, \
                    open(os.path.join(td, name), "rb") as b:
                assert a.read() == b.read(), name
    assert manifest(td) == manifest(jd)     # the treedef string included

    # the port reads the reference's checkpoint ...
    got, got_extra = tck.CheckpointManager(str(tmp_path / "ref")).restore(
        3, ttree, partition=partition, device="cpu")
    assert got_extra == extra
    assert_bit_equal(got, ttree)
    if kind == "g_opt":
        assert isinstance(got[0], Gaussians)
        assert isinstance(got[1], ttr.GSOptState)
        assert list(got[1].m) == list(FIELDS)   # the template's key order
        assert got[0].active.dtype == torch.bool
        assert got[1].step.shape == () and got[1].step.dtype == torch.int32
    # ... and the reference reads the port's
    jgot, _ = jck.CheckpointManager(str(tmp_path / "port")).restore(
        3, jtree, partition=partition)
    assert_bit_equal(jgot, jtree)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("base_writer", ["port", "ref"])
def test_delta_chain_crosses_packages(tmp_path, base_writer, quantized):
    """A full base from one package, a delta over it from the other, and a
    second delta over that from the first: every step restores exactly in
    both packages (int8 cold-quantized fields included)."""
    g = j_model(1)
    r = np.random.default_rng(5)
    t = [g]
    for _ in range(2):                    # two sparse row edits
        rows = r.choice(g.means.shape[0], 7, replace=False)
        means = np.array(t[-1].means)
        means[rows] += 0.01
        cols = np.array(t[-1].colors)
        cols[rows[:3]] -= 0.2
        t.append(t[-1]._replace(means=jnp.asarray(means),
                                colors=jnp.asarray(cols)))
    if quantized:
        t = [jck.quantize_cold(x)[0] for x in t]
    ports = [to_port(x) if not quantized else Gaussians(**{
        k: torch.from_numpy(np.array(v)) for k, v in x._asdict().items()})
        for x in t]
    root = str(tmp_path / "chain")
    port = (tck.CheckpointManager(root, keep=0), ports)
    ref = (jck.CheckpointManager(root, keep=0), t)
    (first, first_t), (second, second_t) = \
        (port, ref) if base_writer == "port" else (ref, port)
    first.save(2, first_t[0])
    second.save_delta(4, second_t[1], base_step=2)
    first.save_delta(6, first_t[2], base_step=4)
    with open(os.path.join(root, "step_000000006", "manifest.json")) as f:
        assert "rows" in {m["delta"] for m in json.load(f)["leaves"]}
    for step, want_j, want_t in zip((2, 4, 6), t, ports):
        got_t = port[0].restore_delta(step, tck.unshaped_like(Gaussians),
                                      device="cpu")[0]
        got_j = ref[0].restore_delta(step,
                                     jck.unshaped_like(jg.Gaussians))[0]
        assert_bit_equal(got_t, want_t)
        assert_bit_equal(got_j, want_j)


@pytest.mark.parametrize("fault", ["replaced", "missing", "no_base",
                                   "structure", "plain_restore"])
def test_delta_refusals(tmp_path, fault):
    """The port refuses, with ValueError, a delta whose base was replaced or
    removed, a delta with no committed base or of another structure, and a
    plain ``restore`` of a delta step -- over a reference-written base."""
    g = j_model(2)
    tg = to_port(g)
    root = str(tmp_path)
    jck.CheckpointManager(root, keep=0).save(2, g)
    tm = tck.CheckpointManager(root, keep=0)
    like = tck.unshaped_like(Gaussians)
    if fault == "no_base":
        with pytest.raises(ValueError, match="missing or incomplete"):
            tm.save_delta(4, tg, base_step=3)
        return
    if fault == "structure":
        with pytest.raises(ValueError, match="does not match"):
            tm.save_delta(4, {"means": tg.means}, base_step=2)
        return
    tm.save_delta(4, tg._replace(means=tg.means + 1), base_step=2)
    if fault == "plain_restore":
        with pytest.raises(ValueError, match="DELTA"):
            tm.restore(4, like, device="cpu")
        return
    if fault == "replaced":
        tm.save(2, tg._replace(colors=tg.colors * 0))
        match = "DIFFERENT base"
    else:
        shutil.rmtree(os.path.join(root, "step_000000002"))
        match = "needs base step 2"
    with pytest.raises(ValueError, match=match):
        tm.restore_delta(4, like, device="cpu")


@pytest.mark.parametrize("tree,want", [
    (None, "PyTreeDef(None)"),
    ((), "PyTreeDef(())"),
    ([1, (2, None), {}], "PyTreeDef([*, (*, None), {}])"),
    ({"b": None, "a": (1,)}, "PyTreeDef({'a': (*,), 'b': None})"),
])
def test_treedef_string_matches_reference(tree, want):
    assert str(jax.tree.flatten(tree)[1]) == want
    assert str(tck.tree_flatten(tree)[1]) == want


def test_unrepresentable_leaf_dtype_raises(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    # bfloat16 leaves are saved in the reference's form (test_torch_lm_cli.py);
    # fp8 has none
    tree = {"a": torch.zeros(3), "b": torch.zeros(3, dtype=torch.float8_e4m3fn)}
    with pytest.raises(TypeError, match="leaf 1"):
        mgr.save(1, tree)
    assert mgr.all_steps() == []


# ---------------------------------------------------------------------------
# Manager semantics
# ---------------------------------------------------------------------------


def x_tree(value, n=2):
    return {"x": torch.full((n,), float(value))}


def test_atomic_commit_and_retention(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, x_tree(s))
    assert mgr.all_steps() == [3, 4]
    # a crash mid-write: a .tmp directory, a directory with no _COMPLETE
    os.makedirs(tmp_path / "step_000000005.tmp")
    os.makedirs(tmp_path / "step_000000006")
    (tmp_path / "step_000000006" / "manifest.json").write_text("{}")
    assert mgr.latest_step() == 4
    got, _, step = mgr.restore_latest(x_tree(0), device="cpu")
    assert step == 4 and float(got["x"][0]) == 4


def test_restore_latest_is_partition_aware(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=0)
    like = x_tree(0)
    got, extra, step = mgr.restore_latest(like, device="cpu")
    assert step is None and extra == {} and got is like
    mgr.save(10, x_tree(1), partition=0)
    mgr.save(10, x_tree(2), partition=1, extra={"k": 1})
    mgr.save(20, x_tree(3), partition=0)
    got, extra, step = mgr.restore_latest(like, partition=1, device="cpu")
    assert step == 10 and float(got["x"][0]) == 2 and extra == {"k": 1}
    got, _, step = mgr.restore_latest(like, partition=0, device="cpu")
    assert step == 20 and float(got["x"][0]) == 3
    assert mgr.restore_latest(like, partition=2, device="cpu")[2] is None
    assert mgr.latest_step() == 20 and mgr.all_steps(partition=1) == [10]
    assert mgr.restore_latest(like, device="cpu")[2] is None
    mgr.save(15, x_tree(7))
    got, _, step = mgr.restore_latest(like, device="cpu")
    assert step == 15 and float(got["x"][0]) == 7
    assert mgr.manifest_extra(10, partition=1) == {"k": 1}


def test_restore_asserts_shapes_and_leaf_count(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(1, trees("dict")[1])
    bad = {"w": torch.zeros(4, 4), "nested": {
        "b": torch.zeros(10, dtype=torch.int32), "s": torch.tensor(0.0)}}
    with pytest.raises(AssertionError, match="leaf 2: shape"):
        mgr.restore(1, bad, device="cpu")
    with pytest.raises(AssertionError, match="leaf count mismatch"):
        mgr.restore(1, tck.unshaped_like({"one_leaf": 0}), device="cpu")


def test_unshaped_like(tmp_path):
    tmpl = tck.unshaped_like(Gaussians)
    assert isinstance(tmpl, Gaussians)
    assert all(x is tck.UNSHAPED for x in tmpl)
    tree = trees("dict")[1]
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    got, _ = mgr.restore(1, tck.unshaped_like(tree), device="cpu")
    assert_bit_equal(got, tree)


def test_restore_defaults_to_the_card(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(1, x_tree(1))
    if torch.cuda.is_available():
        got, _ = mgr.restore(1, x_tree(0))
        assert got["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(1, x_tree(0))


# ---------------------------------------------------------------------------
# int8 cold quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_quantize_cold_is_bit_identical(seed):
    g = j_model(seed)
    jq, jmeta = jck.quantize_cold(g)
    tq, tmeta = tck.quantize_cold(to_port(g))
    assert tmeta == jmeta
    for name in jck.COLD_QUANT_FIELDS:
        a, b = np.asarray(getattr(jq, name)), getattr(tq, name).numpy()
        assert b.dtype == np.int8 and a.tobytes() == b.tobytes()
    jd = jck.dequantize_cold(jq, jmeta)
    td = tck.dequantize_cold(tq, tmeta)
    assert_bit_equal(td, jd)
    assert tck.dequantize_cold(tq, None) is tq
    with pytest.raises(ValueError, match="quant mode"):
        tck.dequantize_cold(tq, {"mode": "int4", "fields": {}})


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------


def tiny_setup():
    """The reference's ``_tiny_fit_setup`` (tests/test_runtime.py) in both
    packages: 128 splats, 64 free slots, a 2-view 32x32 rig, grey GT."""
    g = jg.from_points(*(jnp.asarray(a[:128]) for a in
                         point_cloud_for("sphere_shell", 128)),
                       capacity=192, opacity=0.7)
    cams = jc.orbital_rig(2, CENTER, 1.6, width=RES, height=RES)
    tcams = tc.orbital_rig(2, CENTER, 1.6, width=RES, height=RES,
                           device="cpu")
    kw = dict(K=8, tile_h=8, tile_w=16, lr_colors=5e-2, max_new=32,
              densify_grad_thresh=1e-9)
    return (g, cams, jnp.full((2, RES, RES, 3), 0.5),
            jtr.GSTrainCfg(impl="ref", **kw), tcams,
            torch.full((2, RES, RES, 3), 0.5), ttr.GSTrainCfg(**kw))


FIT_KW = dict(steps=6, extent=1.0, densify_every=2, densify_from=0)


def j_split_noise(key, n_events, m):
    """The reference's split noise: one ``normal(sub, (m, 3))`` per densify
    event, ``key, sub = split(key)`` before each."""
    out = []
    for _ in range(n_events):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (m, 3))))
    return out


def test_port_resumes_a_reference_checkpoint(tmp_path):
    """The reference trains 6 steps, saving every 3; the port resumes from
    the reference's step-3 checkpoint to step 6, with the reference's split
    noise (events after steps 2, 4, 6; the first is skipped)."""
    g, cams, gts, jcfg, tcams, tgts, tcfg = tiny_setup()
    root = str(tmp_path / "ck")
    jg6, _, jl = jtr.fit_partition(
        g, cams, gts, None, jcfg, key=jax.random.PRNGKey(0),
        grid=JGrid(*DIMS), ckpt=jck.CheckpointManager(root), ckpt_every=3,
        **FIT_KW)
    shutil.rmtree(os.path.join(root, "step_000000006"))
    noise = j_split_noise(jax.random.PRNGKey(0), 3, 32)
    tg6, _, tl = ttr.fit_partition(
        to_port(g), tcams, tgts, None, tcfg, grid=TileGrid(*DIMS),
        ckpt=tck.CheckpointManager(root), densify_noise=noise, **FIT_KW)
    assert len(tl) == 3
    np.testing.assert_allclose(tl, jl[3:], rtol=1e-4, atol=0)
    np.testing.assert_array_equal(tg6.active.numpy(), np.asarray(jg6.active))


@pytest.mark.parametrize("noise", ["generator", "injected"])
def test_port_resume_equals_uninterrupted_run(tmp_path, monkeypatch, noise):
    """Interrupted after step 3 and resumed to 6, the port's losses and
    state equal its uninterrupted run's; the resumed run keeps the saved
    tier caps (no initial probe) and re-probes once per densify event after
    step 3 (events after steps 4 and 6)."""
    g, *_, tcams, tgts, tcfg = tiny_setup()
    g0 = to_port(g)
    kw = dict(grid=TileGrid(*DIMS), ckpt_every=3, **FIT_KW)
    if noise == "injected":
        kw["densify_noise"] = j_split_noise(jax.random.PRNGKey(1), 3, 32)

    def gen():
        return torch.Generator().manual_seed(11)

    full = ttr.fit_partition(g0, tcams, tgts, None, tcfg, generator=gen(),
                             ckpt=tck.CheckpointManager(str(tmp_path / "f")),
                             **kw)
    mgr = tck.CheckpointManager(str(tmp_path / "ab"))
    s_a = tcfg.tier_schedule()
    ga, opta, _ = ttr.fit_partition(g0, tcams, tgts, None, tcfg,
                                    generator=gen(), schedule=s_a, ckpt=mgr,
                                    **{**kw, "steps": 3})
    (gs, opts), extra = mgr.restore(3, (g0, ttr.init_opt(g0)), device="cpu")
    assert_bit_equal((gs, opts), (ga, opta))
    assert TierSchedule.from_state(extra["schedule"]).tier_caps \
        == s_a.tier_caps
    assert extra["dtype_policy"] == "f32" and extra["grad_compress"] == "none"

    probes = {"n": 0}
    real_probe = ttr.occupancy_probe

    def counting_probe(*a, **k):
        probes["n"] += 1
        return real_probe(*a, **k)

    monkeypatch.setattr(ttr, "occupancy_probe", counting_probe)
    s_b = tcfg.tier_schedule()
    gb, optb, lb = ttr.fit_partition(g0, tcams, tgts, None, tcfg,
                                     generator=gen(), schedule=s_b, ckpt=mgr,
                                     **kw)
    assert probes["n"] == 2 and s_b.tier_caps is not None
    assert len(lb) == 3
    np.testing.assert_allclose(lb, full[2][3:], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(gb.active.numpy(), full[0].active.numpy())
    assert mgr.all_steps() == [3, 6]


@pytest.mark.parametrize("knob,saved", [("dtype_policy", "bf16"),
                                        ("grad_compress", "int8")])
def test_resume_refuses_another_policy(tmp_path, knob, saved):
    g, *_, tcams, tgts, tcfg = tiny_setup()
    g0 = to_port(g)
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save(2, (g0, ttr.init_opt(g0)), extra={knob: saved})
    with pytest.raises(ValueError, match=f"{knob}={saved!r}"):
        ttr.fit_partition(g0, tcams, tgts, None, tcfg, grid=TileGrid(*DIMS),
                          ckpt=mgr, **FIT_KW)


# ---------------------------------------------------------------------------
# Serving from a checkpoint
# ---------------------------------------------------------------------------


def write_merged(ckpt_dir, quantized):
    """The merged checkpoint ``launch/train.py --gs`` writes, by the
    reference: the model under ``<ckpt_dir>/merged`` with the scene frame
    (and the int8 scales) on ``extra``."""
    pts, cols = point_cloud_for("sphere_shell", 400)
    g = jg.from_points(jnp.asarray(pts), jnp.asarray(cols), opacity=0.9)
    extra = {"scene": {
        "dataset": "sphere_shell", "resolution": RES,
        "center": list(CENTER), "radius": 1.5, "extent": 1.7,
        "n_views": 4, "K": 16, "tile_h": 8, "tile_w": 16}}
    if quantized:
        g, extra["quant"] = jck.quantize_cold(g)
    jck.CheckpointManager(os.path.join(ckpt_dir, "merged"), keep=2).save(
        6, g, extra=extra)
    return extra


@pytest.mark.parametrize("quantized", [False, True])
def test_serve_a_reference_checkpoint(tmp_path, quantized):
    ckpt = str(tmp_path / "gs")
    extra = write_merged(ckpt, quantized)
    jserver, jextra = js.GSRenderServer.from_checkpoint(ckpt, max_batch=4)
    tserver, textra = ts.GSRenderServer.from_checkpoint(ckpt, device="cpu",
                                                        max_batch=4)
    assert textra == jextra == extra
    assert tserver.cfg == ts.ServeCfg(K=16, max_batch=4)
    assert tserver.lod_dists == jserver.lod_dists
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(tserver.ladder[0], name).numpy(),
            np.asarray(getattr(jserver.ladder[0], name)))
    # near views on rung 0, far ones past the auto LOD threshold (4 x 1.5)
    jrigs = [jc.orbital_rig(2, CENTER, r, width=RES, height=RES)
             for r in (1.5, 8.0)]
    jrig = jc.Camera(*(jnp.concatenate([a, b]) for a, b in
                       zip(jrigs[0][:3], jrigs[1][:3])), RES, RES)
    trig = tc.concat([tc.orbital_rig(2, CENTER, r, width=RES, height=RES,
                                     device="cpu") for r in (1.5, 8.0)])
    served = list(zip(jserver.serve(jrig), tserver.serve(trig)))
    assert {tr.rung for _, tr in served} == {0, 1}
    for jr, tr in served:
        np.testing.assert_allclose(tr.rgb, jr.rgb, rtol=IMG_TOL, atol=IMG_TOL)
        assert (tr.rung, tr.K, tr.cache_hit) == (jr.rung, jr.K, jr.cache_hit)
    want_tel = jserver.telemetry()
    # the port keeps no "tiles" counter; the reference's always reads 0
    assert want_tel.pop("tiles") == 0
    assert tserver.telemetry() == want_tel


def test_serve_gs_cli_matches_reference(tmp_path, monkeypatch, capsys):
    """``serve_gs.main`` on the CPU: exit 0, the repeat pass all hits, and
    the telemetry JSON carries the reference CLI's telemetry, hits and
    rungs for the same checkpoint and flags."""
    ckpt = str(tmp_path / "gs")
    write_merged(ckpt, quantized=False)
    flags = ["--ckpt-dir", ckpt, "--views", "6", "--max-batch", "2",
             "--passes", "2", "--far", "8"]
    out_t, out_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert serve_gs.main(flags + ["--telemetry-json", out_t,
                                  "--device", "cpu"]) == 0
    assert "[serve-gs] ok" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve_gs"] + flags
                        + ["--telemetry-json", out_j])
    j_serve_gs.main()
    with open(out_t) as f:
        got = json.load(f)
    with open(out_j) as f:
        want = json.load(f)
    assert want["telemetry"].pop("tiles") == 0
    assert got["telemetry"] == want["telemetry"]
    assert got["scene"] == want["scene"]
    for a, b in zip(got["passes"], want["passes"]):
        assert (a["requests"], a["hits"], a["rungs"]) \
            == (b["requests"], b["hits"], b["rungs"])
    assert got["passes"][1]["hits"] == 6 and got["passes"][0]["rungs"] == [0, 1]


def test_from_checkpoint_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="no merged checkpoint"):
        ts.GSRenderServer.from_checkpoint(str(tmp_path), device="cpu")
    write_merged(str(tmp_path), quantized=False)
    with pytest.raises(ValueError, match="not both"):
        ts.GSRenderServer.from_checkpoint(str(tmp_path), ts.ServeCfg(),
                                          device="cpu", max_batch=2)


# ---------------------------------------------------------------------------
# Fault tolerance
# ---------------------------------------------------------------------------


def test_retry_step_recovers_then_reraises():
    calls = {"n": 0}
    failures = []

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return x + 1

    assert ft.retry_step(flaky, 1, retries=3,
                         on_failure=lambda a, e: failures.append(a)) == 2
    assert calls["n"] == 3 and failures == [0, 1]
    with pytest.raises(RuntimeError, match="perm"):
        ft.retry_step(lambda: (_ for _ in ()).throw(RuntimeError("perm")),
                      retries=1)


def test_heartbeat_staleness(tmp_path):
    hb0 = ft.Heartbeat(str(tmp_path), "w0", interval=0)
    hb1 = ft.Heartbeat(str(tmp_path), "w1", interval=0)
    hb0.beat(1, force=True)
    hb1.beat(1, force=True)
    assert hb0.stale(timeout=60) == []
    rec = json.loads(open(hb1.path()).read())
    rec["time"] -= 120
    open(hb1.path(), "w").write(json.dumps(rec))
    assert hb0.stale(timeout=60) == ["w1"]


def test_bounded_staleness_merge(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), keep=0)
    mgr.save(10, x_tree(10), partition=0)
    mgr.save(10, x_tree(11), partition=1)
    mgr.save(20, x_tree(20), partition=0)
    got, steps, laggards = ft.bounded_staleness_merge(
        mgr, 2, x_tree(0), max_lag=5, device="cpu")
    assert steps == [20, 10] and laggards == [1]
    assert float(got[0]["x"][0]) == 20 and float(got[1]["x"][0]) == 11
    assert got[0]["x"].device.type == "cpu"
