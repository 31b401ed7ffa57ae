"""The port's training CLI launched the way users launch it on several
devices: ``python -m torch.distributed.run --standalone --nproc-per-node 2``
(``torchrun``), one gloo CPU rank a process, each rank joining the group
through the ``env://`` branch of ``launch.mesh.init_distributed``.  The
ranks run ``tests/_torch_dist_cli.py`` (``launch.train.main`` under
``torch.use_deterministic_algorithms(True)``, logging every file the rank
writes).  Each run is held against the in-process world-1 run of the same
flags (``--mesh`` dropped):

- ``--gs --smoke --mesh 2x1``, and the same with ``--exchange``: the
  per-step losses, the global ``step_*`` trees, the merged checkpoint and
  its PSNR / SSIM.
- ``--gs --timeseries --smoke --mesh 2x1``: a run stopped after timestep 0
  and restarted to 2 timesteps equals the uninterrupted 2-rank run bit for
  bit (losses, the delta chain's files, the merged checkpoint), and the
  uninterrupted run matches world 1.
- Checkpoints cross world sizes: world 1's step 2 resumed on the 2x1 mesh,
  the 2x1 mesh's step 2 resumed at world 1, and the 2-rank chain's
  timestep 0 restarted at world 1, each against world 1's own run.

Gates, each with its reason: losses at rtol 1e-5 / atol 1e-6 (the
distributed trainer's, ``tests/test_torch_distributed.py``); live slots,
owners, Adam's step and the densify counts equal; each trained field
within 2 * steps * its learning rate, the most Adam's near-unit steps let
two runs whose gradients differ in rounding drift apart (the card gate of
``tests/test_torch_cuda.py``: a component whose gradient is ~0 may step
either way; the gradients are float32 sums in another order, over the
"part" reduce-scatter), and 99.9% of its components within 2e-5 (the
distributed tests' gate for another summation order); the Adam moments
and the densify gradient sums, 99% of their components within 1e-5 of the
field's largest magnitude (the card gate's share: the rest belong to
splats whose neighbours took another Adam step).  The 2x1 mesh
rounds the batched capacity up to a multiple of 2: the slots past world
1's capacity stay dead (densify is held to it), so the trees are compared
on world 1's slots.  Every file is written once, by rank 0.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist_cli import LEAVES, Torchrun, global_tree  # noqa: E402
from _torch_dist_cli import check_merged as _check_merged  # noqa: E402
from _torch_dist_cli import check_trees as _check_trees  # noqa: E402
from repro_torch.core.train import GSTrainCfg, group_lrs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.train import read_record as record  # noqa: E402
from repro_torch.runtime.checkpoint import (UNSHAPED,  # noqa: E402
                                            CheckpointManager)

#: each torchrun's wall limit (a smoke run takes ~10 s)
RUN_TIMEOUT_S = 150

SMOKE = ["--gs", "--smoke", "--device", "cpu"]
GS_STEPS = 4
TS = ["--gs", "--timeseries", "--smoke", "--device", "cpu", "--steps", "3"]
TS_STEPS = 3

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
GATES = dict(field_tol=2e-5, field_share=0.999)
MOMENTS = dict(moment_tol=1e-5, moment_share=0.99)  # of the largest |x|


def run2(tmp, tag, argv):
    """The CLI on two torchrun ranks, write logs under ``tmp``."""
    return Torchrun(argv, nproc=2, log=str(tmp / f"{tag}_writes"),
                    timeout=RUN_TIMEOUT_S)


def world1(argv):
    """``launch.train.main(argv)`` in this process (a world of one) -> its
    standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train.main(argv) == 0
    return buf.getvalue()


def check_trees(got, want, lrs, steps):
    _check_trees(got, want, lrs, steps, **GATES, **MOMENTS)


def check_merged(got_root, want_root, step, lrs, steps):
    _check_merged(got_root, want_root, step, lrs, steps, **GATES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every torchrun starts at once (two ranks each); the world-1 runs go
    in this process meanwhile; the timeseries restart waits for its first
    half."""
    tmp = tmp_path_factory.mktemp("torchrun")
    d = {k: tmp / k for k in ("gs2", "gs1", "ex2", "ex1", "ts2", "ts_split",
                               "ts1", "r12", "r21", "ts_r21")}
    gs = SMOKE + ["--steps", str(GS_STEPS)]
    ex = gs + ["--exchange"]
    mesh = ["--mesh", "2x1"]
    jobs = {
        "gs2": run2(tmp, "gs2", gs + mesh + ["--ckpt-dir", str(d["gs2"])]),
        "ex2": run2(tmp, "ex2", ex + mesh + ["--ckpt-dir", str(d["ex2"])]),
        "ts2": run2(tmp, "ts2", TS + mesh + [
            "--timesteps", "2", "--ckpt-dir", str(d["ts2"])]),
        "ts_a": run2(tmp, "ts_a", TS + mesh + [
            "--timesteps", "1", "--ckpt-dir", str(d["ts_split"])]),
    }
    out = {"dirs": d}
    step2 = "step_000000002"
    try:
        out["gs1"] = world1(gs + ["--ckpt-dir", str(d["gs1"])])
        # world 1's step 2, resumed on two ranks
        shutil.copytree(d["gs1"] / step2, d["r12"] / step2)
        jobs["r12"] = run2(tmp, "r12", gs + mesh + ["--ckpt-dir",
                                                    str(d["r12"])])
        out["ex1"] = world1(ex + ["--ckpt-dir", str(d["ex1"])])
        out["ts1"] = world1(TS + ["--timesteps", "2", "--ckpt-dir",
                                  str(d["ts1"])])
        out["ts_a"] = jobs.pop("ts_a").wait()
        # the 2-rank chain's timestep 0, restarted here and on two ranks
        shutil.copytree(d["ts_split"], d["ts_r21"])
        jobs["ts_b"] = run2(tmp, "ts_b", TS + mesh + [
            "--timesteps", "2", "--ckpt-dir", str(d["ts_split"])])
        out["ts_r21"] = world1(TS + ["--timesteps", "2", "--ckpt-dir",
                                     str(d["ts_r21"])])
        # the 2x1 mesh's step 2, resumed at world 1
        out["gs2"] = jobs.pop("gs2").wait()
        shutil.copytree(d["gs2"] / step2, d["r21"] / step2)
        out["r21"] = world1(gs + ["--ckpt-dir", str(d["r21"])])
        for k in list(jobs):
            out[k] = jobs.pop(k).wait()
    finally:
        for job in jobs.values():
            job.kill()
    return out


def check_written_once(writes, want):
    """Rank 0 wrote each of ``want`` (paths) once; no other rank wrote."""
    assert all(w == [] for w in writes[1:]), writes
    assert sorted(writes[0]) == sorted(os.path.abspath(str(p)) for p in want)


def check_records(got, want):
    assert got["world"] == 2 and want["world"] == 1 and got["mesh"] == [2, 1]
    assert got["live"] == want["live"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose([got["psnr"], got["ssim"]],
                               [want["psnr"], want["ssim"]], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert [r["rank"] for r in got["ranks"]] == [0, 1]


def chain_state(root, step):
    """A ``--timeseries`` run's (g, opt) at ``step`` through its delta
    chain -> {leaf: array}."""
    tree, extra = CheckpointManager(str(root / "timeseries"), keep=0) \
        .restore_delta(step, [UNSHAPED] * len(LEAVES), device="cpu")
    assert extra["timestep"] == step // TS_STEPS - 1
    return dict(zip(LEAVES, (x.numpy() for x in tree)))


def lrs_of(root, step):
    with open(os.path.join(root, "merged", f"step_{step:09d}",
                           "manifest.json")) as f:
        extent = json.load(f)["extra"]["scene"]["extent"]
    return group_lrs(GSTrainCfg(), extent)


@pytest.mark.parametrize("tag", ["gs", "ex"])
def test_torchrun_cli_matches_world_one(runs, tag):
    """``--gs --smoke`` (and ``--exchange``) on a 2x1 mesh of two torchrun
    ranks against world 1: losses, the ``step_*`` trees (steps 2 and 4),
    the merged checkpoint; rank 0 alone wrote, each file once."""
    d = runs["dirs"]
    text2, writes = runs[f"{tag}2"]
    got, want = record(text2, "[train-gs]"), record(runs[f"{tag}1"],
                                                    "[train-gs]")
    check_records(got, want)
    if tag == "ex":
        assert "table=exchange " in text2, text2
    root2, root1 = str(d[f"{tag}2"]), str(d[f"{tag}1"])
    lrs = lrs_of(root1, GS_STEPS)
    steps = CheckpointManager(root1, keep=0).all_steps()
    assert steps == CheckpointManager(root2, keep=0).all_steps() == [2, 4]
    for step in steps:
        check_trees(global_tree(root2, step), global_tree(root1, step), lrs,
                    step)
    check_merged(root2, root1, GS_STEPS, lrs, GS_STEPS)
    want_files = [d[f"{tag}2"] / f"step_{s:09d}" for s in steps] + [
        d[f"{tag}2"] / "partitions" / f"step_{GS_STEPS:09d}" / f"partition_{p}"
        for p in (0, 1)] + [d[f"{tag}2"] / "merged" / f"step_{GS_STEPS:09d}",
                            d[f"{tag}2"] / "render_final.npy"]
    check_written_once(writes, want_files)


def test_torchrun_timeseries_restart_equals_uninterrupted(runs):
    """Two ranks: ``--timesteps 1`` then ``--timesteps 2`` in one directory
    equals ``--timesteps 2`` uninterrupted, bit for bit: the losses, every
    file of the delta chain, the merged checkpoint and the final render."""
    d = runs["dirs"]
    (ta, wa), (tb, wb) = runs["ts_a"], runs["ts_b"]
    a, b = record(ta, "[train-gs-ts]"), record(tb, "[train-gs-ts]")
    whole = record(runs["ts2"][0], "[train-gs-ts]")
    assert "restarting at timestep 1 (chain committed through step 3)" in tb
    assert (a["t_start"], b["t_start"], whole["t_start"]) == (0, 1, 0)
    assert a["losses"] + b["losses"] == whole["losses"]
    assert len(whole["losses"]) == 2
    split, full = str(d["ts_split"]), str(d["ts2"])
    for sub in ("timeseries/step_000000003", "timeseries/step_000000006",
                f"merged/step_{2 * TS_STEPS:09d}"):
        names = sorted(f for f in os.listdir(os.path.join(full, sub))
                       if f.endswith(".npy"))
        assert names == sorted(f for f in os.listdir(os.path.join(split, sub))
                               if f.endswith(".npy"))
        for f in names:
            x, y = (np.load(os.path.join(r, sub, f)) for r in (split, full))
            np.testing.assert_array_equal(x, y, err_msg=f"{sub}/{f}")
    np.testing.assert_array_equal(
        np.load(os.path.join(split, "render_final.npy")),
        np.load(os.path.join(full, "render_final.npy")))
    # each run wrote its timestep's commit and outputs, once, on rank 0
    for writes, step in ((wa, TS_STEPS), (wb, 2 * TS_STEPS)):
        check_written_once(writes, [
            d["ts_split"] / "timeseries" / f"step_{step:09d}",
            d["ts_split"] / "partitions" / f"step_{step:09d}" / "partition_0",
            d["ts_split"] / "partitions" / f"step_{step:09d}" / "partition_1",
            d["ts_split"] / "merged" / f"step_{step:09d}",
            d["ts_split"] / "render_final.npy"])


def test_torchrun_timeseries_matches_world_one(runs):
    """The uninterrupted 2-rank ``--timeseries`` run against world 1: each
    timestep's losses, the chain's final state through its delta restore,
    the merged checkpoint."""
    d = runs["dirs"]
    got = record(runs["ts2"][0], "[train-gs-ts]")
    want = record(runs["ts1"], "[train-gs-ts]")
    assert got["world"] == 2 and got["mesh"] == [2, 1]
    for g, w in zip(got["losses"], want["losses"]):
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert got["live"] == want["live"]
    step = 2 * TS_STEPS
    lrs = lrs_of(str(d["ts1"]), step)
    check_trees(chain_state(d["ts2"], step), chain_state(d["ts1"], step),
                lrs, step)
    check_merged(str(d["ts2"]), str(d["ts1"]), step, lrs, step)


@pytest.mark.parametrize("tag", ["r12", "r21"])
def test_resume_across_world_sizes(runs, tag):
    """A step-2 checkpoint written at one world size resumes at the other
    ("r12": world 1's on the 2x1 mesh, whose capacity is rounded up a slot;
    "r21": the 2x1 mesh's at world 1, its dead padding slot cut): the
    resumed steps 3-4, the step-4 tree and the merged checkpoint against
    world 1's uninterrupted run."""
    d = runs["dirs"]
    text = runs[tag][0] if tag == "r12" else runs[tag]
    assert "resuming from checkpoint step 2" in text, text[-3000:]
    got = record(text, "[train-gs]")
    want = record(runs["gs1"], "[train-gs]")
    assert got["world"] == (2 if tag == "r12" else 1)
    np.testing.assert_allclose(got["losses"], want["losses"][2:],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    root, base = str(d[tag]), str(d["gs1"])
    lrs = lrs_of(base, GS_STEPS)
    check_trees(global_tree(root, GS_STEPS), global_tree(base, GS_STEPS),
                lrs, GS_STEPS)
    check_merged(root, base, GS_STEPS, lrs, GS_STEPS)


def test_timeseries_restart_across_world_sizes(runs):
    """The 2-rank chain's timestep 0 (its capacity rounded up a slot),
    restarted at world 1 to 2 timesteps: timestep 1's losses, the chain's
    final state and the merged checkpoint against world 1's uninterrupted
    run."""
    d = runs["dirs"]
    text = runs["ts_r21"]
    assert "restarting at timestep 1 (chain committed through step 3)" \
        in text, text[-3000:]
    got = record(text, "[train-gs-ts]")
    want = record(runs["ts1"], "[train-gs-ts]")
    assert got["world"] == 1 and got["t_start"] == 1
    np.testing.assert_allclose(got["losses"][0], want["losses"][1],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    step = 2 * TS_STEPS
    lrs = lrs_of(str(d["ts1"]), step)
    check_trees(chain_state(d["ts_r21"], step), chain_state(d["ts1"], step),
                lrs, step)
    check_merged(str(d["ts_r21"]), str(d["ts1"]), step, lrs, step)


def fit_slots_state(n, live, parts=2):
    """A global (g, opt, int8 residual) state of ``parts`` partitions of
    ``n`` slots, ``live`` of them live."""
    from repro_torch.core.distributed import zero_err
    from repro_torch.core.gaussians import from_points
    from repro_torch.core.train import init_opt

    pts = torch.rand((parts, live, 3), generator=torch.Generator()
                     .manual_seed(n))
    gs = [from_points(p, p, capacity=n, device="cpu") for p in pts]
    g = type(gs[0])(*(torch.stack(f) for f in zip(*gs)))
    return g, init_opt(g), zero_err(g, "int8")


def test_fit_slots_pads_cuts_and_refuses_live_slots():
    """``distributed.fit_slots`` on a (2, N) state: N - 1 slots padded from
    the fresh layout's dead rows, N + 1 cut back when the cut slot is dead,
    a ValueError when it is live; every slot leaf (the splats, both
    moments, the densify sums, the int8 residual) fitted, the step kept."""
    from repro_torch.core.distributed import fit_slots
    from repro_torch.runtime.checkpoint import tree_flatten

    like = fit_slots_state(8, 6)
    for n in (7, 8, 9):
        tree = fit_slots_state(n, 6)
        got = fit_slots(tree, like)
        for x, ref in zip(tree_flatten(got)[0], tree_flatten(like)[0]):
            assert x.shape == ref.shape
        assert got[1].step is tree[1].step
        np.testing.assert_array_equal(got[0].active.numpy(),
                                      like[0].active.numpy())
        np.testing.assert_array_equal(got[0].means[:, :6].numpy(),
                                      tree[0].means[:, :6].numpy())
    with pytest.raises(ValueError, match="live past 8"):
        fit_slots(fit_slots_state(9, 9), like)


@pytest.mark.parametrize("case", ["parts", "width", "step", "live"])
def test_fit_slots_refuses_another_layout(case):
    """A checkpoint of another run's layout is refused with the leaf's
    shape, as the checkpoint's own shape check refused it: another
    partition count at the same N ("parts"), another field width
    ("width"), another step shape ("step"), and a shorter N' than a fresh
    layout that is live past it ("live")."""
    from repro_torch.core.distributed import fit_slots

    like = fit_slots_state(8, 6)
    tree = fit_slots_state(8, 6)
    match = "it is not this run's"
    if case == "parts":
        tree = fit_slots_state(8, 6, parts=3)
    elif case == "width":
        tree = (tree[0]._replace(colors=tree[0].colors[..., :2]),) + tree[1:]
    elif case == "step":
        tree = (tree[0], tree[1]._replace(step=tree[1].step[None])) + tree[2:]
        match = "leaf step"
    else:
        like, tree = fit_slots_state(8, 8), fit_slots_state(7, 6)
    with pytest.raises(ValueError, match=match):
        fit_slots(tree, like)
