"""Port parity: the timeseries driver -- ``pipeline.TimestepData``,
``prepare_timestep``, ``TimestepPrefetcher`` and ``launch.train
--timeseries`` -- and the kernel loader's guard against two threads.

Gates, each with its reason:

- ``prepare_timestep`` against the reference's at t = 0 and t = 0.1
  (sphere_shell, CPU tier, 32x32, 4 views, 2 partitions): points, colors,
  partitions and the g0 fields bit for bit, except ``log_scales`` and
  ``colors``, which are a ``log`` of the same float32 value and differ by
  at most one ulp (XLA's and torch's ``log`` round a last bit apart); GTs
  at 1e-5 (the image gate) at the same render batch; masks equal wherever
  the coverage is 1e-5 away from the 1/255 threshold.
- The CLI against the reference's ``run_gs_timeseries``, in this process
  on one JAX CPU device, with no densify event (``--densify-every 100``:
  jax 0.9 raises in the reference's densify, ROADMAP queue 3; with
  ``--densify-every 0`` the capacity is t = 0's largest partition, which
  the sphere's t = 0.1 partitions outgrow, as both packages report).
  Timestep 0's losses at rtol 1e-5 / atol 1e-6 (the distributed trainer's
  gate).  Later timesteps start from each package's own trained state,
  and eps = 1e-15 Adam turns a rounding-level difference of a near-zero
  gradient into a whole learning-rate step (ROADMAP queue 3), so they are
  held from ONE state instead: the port continues the reference's
  committed chain, and its first step of the new timestep equals the
  reference's own continuation at the same gate.  The delta manifests'
  extras, bases and leaf layouts are the reference's; the merge tail run
  on the reference's complete chain writes the reference's merged
  checkpoint bit for bit and its ``render_final.npy`` at 1e-5.
- With densify, the port against itself: ``--timesteps 2`` then ``3``
  equals 3 uninterrupted (losses bit for bit, trainables at 1e-6), a
  complete chain skips to the merge, and a warm-started timestep makes no
  initial tier probe.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as jtrain  # noqa: E402
from repro.configs.gs_datasets import get_gs_dataset as j_dataset  # noqa: E402
from repro.core import cameras as jc  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core import pipeline as jpl  # noqa: E402
from repro.core.masking import dilate_mask  # noqa: E402
from repro.core.tiling import TileGrid as JGrid  # noqa: E402
from repro.runtime import CheckpointManager as JCkpt  # noqa: E402
from repro_torch.configs.gs_datasets import get_gs_dataset  # noqa: E402
from repro_torch.core import cameras as tc  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import pipeline as tpl  # noqa: E402
from repro_torch.core.tiling import TileGrid  # noqa: E402
from repro_torch.kernels import rasterize  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402

IMG_TOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
RES, VIEWS, K = 32, 4, 16
TRAINED = ("means", "log_scales", "quats", "opacity_logit", "colors")


# ---------------------------------------------------------------------------
# prepare_timestep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame():
    """The series frame both packages share: the t = 0 sphere_shell scene's
    rig and grid, and its largest partition as the capacity."""
    jds, tds = j_dataset("sphere_shell", "cpu"), get_gs_dataset(
        "sphere_shell", "cpu")
    pts, cols, ext = jpl.build_scene(jds, 0)
    center = 0.5 * (pts.max(0) + pts.min(0))
    radius = 1.6 * ext / 2 + 1e-3
    jcams = jc.orbital_rig(VIEWS, center, radius, width=RES, height=RES)
    tcams = tc.orbital_rig(VIEWS, center, radius, width=RES, height=RES,
                           device="cpu")
    parts = tpl.partition_points(pts, cols, 2,
                                 ghost_width=tds.ghost_frac * ext)[0]
    cap = max(len(pd.points) for pd in parts)
    return jds, tds, jcams, tcams, cap


@pytest.mark.parametrize("t", [0.0, 0.1])
def test_prepare_timestep_matches_reference(frame, t):
    jds, tds, jcams, tcams, cap = frame
    cap = cap + 8                 # t = 0.1's partitions outgrow t = 0's
    jd = jpl.prepare_timestep(jds, jcams, JGrid(RES, RES, 8, 16), t=t,
                              n_parts=2, capacity=cap, K=K)
    td = tpl.prepare_timestep(tds, tcams, TileGrid(RES, RES, 8, 16), t=t,
                              n_parts=2, capacity=cap, K=K, device="cpu")
    assert isinstance(td, tpl.TimestepData) and td.t == jd.t == t
    np.testing.assert_array_equal(td.points, jd.points)
    np.testing.assert_array_equal(td.colors, jd.colors)
    assert td.extent == jd.extent
    assert len(td.parts) == len(jd.parts) == 2
    for a, b in zip(td.parts, jd.parts):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    for name in jd.g0._fields:
        got, want = getattr(td.g0, name).numpy(), np.asarray(
            getattr(jd.g0, name))
        assert got.shape == want.shape == (2, cap) + want.shape[2:]
        if name in ("log_scales", "colors"):
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert td.gts.shape == (2, VIEWS, RES, RES, 3)
    np.testing.assert_allclose(td.gts.numpy(), np.asarray(jd.gts),
                               rtol=IMG_TOL, atol=IMG_TOL)
    # the masks threshold the coverage at 1/255 and dilate (2 pixels): a
    # pixel may differ only within that reach of a coverage value 1e-5 from
    # the threshold
    near = []
    for pd in jd.parts:
        _, cov = jpl.render_views(jpl.gt_gaussians(pd.points, pd.colors),
                                  jcams, JGrid(RES, RES, 8, 16), K=K, bg=0.0)
        near.append(np.stack([
            np.asarray(dilate_mask(jnp.asarray(
                np.abs(np.asarray(c) - 1.0 / 255.0) <= IMG_TOL), 2))
            for c in cov]))
    differ = td.masks.numpy() != np.asarray(jd.masks)
    assert not (differ & ~np.stack(near)).any()
    assert differ.mean() < 1e-3


def test_prepare_timestep_capacity_refused_by_both(frame):
    """The (P, N) layout is series-fixed: a partition over the capacity
    raises in both packages, naming capacity_factor."""
    jds, tds, jcams, tcams, cap = frame
    with pytest.raises(ValueError, match="capacity_factor"):
        jpl.prepare_timestep(jds, jcams, JGrid(RES, RES, 8, 16), t=0.1,
                             n_parts=2, capacity=cap, K=K)
    with pytest.raises(ValueError, match="capacity_factor"):
        tpl.prepare_timestep(tds, tcams, TileGrid(RES, RES, 8, 16), t=0.1,
                             n_parts=2, capacity=cap, K=K, device="cpu")


# ---------------------------------------------------------------------------
# TimestepPrefetcher
# ---------------------------------------------------------------------------


def test_prefetcher_order_slot_errors_and_close():
    seen = []

    def work(i, *, delay=0.0):
        time.sleep(delay)
        seen.append((i, threading.current_thread().name))
        if i < 0:
            raise KeyError(i)
        return {"i": i, "x": torch.full((2,), float(i))}

    main = threading.current_thread().name
    pf = tpl.TimestepPrefetcher("cpu")
    with pytest.raises(RuntimeError, match="submit"):
        pf.get()
    for i in range(3):
        pf.submit(work, i, delay=0.05)
        with pytest.raises(RuntimeError, match="occupied"):
            pf.submit(work, 99)
        out = pf.get()
        assert out["i"] == i and torch.equal(out["x"], torch.full((2,),
                                                                 float(i)))
    assert [i for i, _ in seen] == [0, 1, 2]
    assert all(name != main for _, name in seen)
    pf.submit(work, -1)
    with pytest.raises(KeyError):
        pf.get()
    # the slot is free again after a failed timestep
    pf.submit(work, 5)
    assert pf.get()["i"] == 5
    pf.submit(work, 6, delay=0.2)
    pf.close()                     # joins the worker: the pending call ran
    assert seen[-1][0] == 6
    assert not any(t.name == seen[-1][1] and t.is_alive()
                   for t in threading.enumerate())
    with tpl.TimestepPrefetcher("cpu") as pf2:
        pf2.submit(work, 7)
        assert pf2.get()["i"] == 7


def test_prefetcher_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.TimestepPrefetcher()


def test_kernel_load_builds_once_from_two_threads(monkeypatch):
    """Two threads making the first kernel call at once build and bind the
    libraries once (a stubbed ``build`` that takes a while)."""
    builds, binds = [], []

    def slow_build(*, verbose=False):
        builds.append(threading.current_thread().name)
        time.sleep(0.2)
        return {"rasterize_fwd": "fwd.so", "rasterize_bwd": "bwd.so"}

    def bind(paths):
        binds.append(paths)
        return {"fwd": object(), "bwd": object()}

    monkeypatch.setattr(rasterize, "_libs", None)
    monkeypatch.setattr(rasterize, "build", slow_build)
    monkeypatch.setattr(rasterize, "_bind", bind)
    got, barrier = [], threading.Barrier(2)

    def first_call():
        barrier.wait()
        got.append(rasterize._load())

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(builds) == len(binds) == 1
    assert len(got) == 2 and got[0] is got[1]


# ---------------------------------------------------------------------------
# the --timeseries CLI
# ---------------------------------------------------------------------------


FLAGS = ["--gs", "--timeseries", "--dataset", "sphere_shell", "--resolution",
         str(RES), "--views", str(VIEWS), "--view-batch", "2", "--steps", "3"]
NO_DENSIFY = ["--densify-every", "100", "--densify-from", "100"]


@contextlib.contextmanager
def recorded(module, calls):
    """``module.fit_partitions`` and ``module.probe_gs_schedule`` with each
    fit's losses (and the probes made inside it) appended to ``calls``."""
    real_fit, real_probe = module.fit_partitions, module.probe_gs_schedule

    def probe(*a, **k):
        calls[-1]["probes"] += 1
        return real_probe(*a, **k)

    def fit(*a, **k):
        calls.append({"probes": 0, "warm": k.get("warm_start") is not None})
        out = real_fit(*a, **k)
        calls[-1]["losses"] = [float(x) for x in out[2]]
        return out

    module.fit_partitions, module.probe_gs_schedule = fit, probe
    try:
        yield calls
    finally:
        module.fit_partitions, module.probe_gs_schedule = real_fit, \
            real_probe


def run_ref(argv):
    """The reference CLI in this process -> (its fit calls, its output)."""
    calls, text = [], io.StringIO()
    old = sys.argv
    sys.argv = ["repro.launch.train"] + argv
    try:
        with recorded(JD, calls), contextlib.redirect_stdout(text):
            jtrain.main()
    finally:
        sys.argv = old
    return calls, text.getvalue()


def run_port(argv):
    """The port's CLI in this process (world 1, CPU) -> (its fit calls, its
    output)."""
    calls, text = [], io.StringIO()
    with recorded(TD, calls), contextlib.redirect_stdout(text):
        assert train.main(argv + ["--device", "cpu"]) == 0
    return calls, text.getvalue()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ts_cli")
    out = {"dir": tmp}
    ref2 = tmp / "ref2"
    out["ref2"] = run_ref(FLAGS + NO_DENSIFY + ["--timesteps", "2",
                                                "--ckpt-dir", str(ref2)])
    for tag in ("merge", "ref3", "port3"):
        shutil.copytree(ref2, tmp / tag)
    out["port2"] = run_port(FLAGS + NO_DENSIFY + [
        "--timesteps", "2", "--ckpt-dir", str(tmp / "port2")])
    out["merge"] = run_port(FLAGS + NO_DENSIFY + [
        "--timesteps", "2", "--ckpt-dir", str(tmp / "merge")])
    out["ref3"] = run_ref(FLAGS + NO_DENSIFY + [
        "--timesteps", "3", "--ckpt-dir", str(tmp / "ref3")])
    out["port3"] = run_port(FLAGS + NO_DENSIFY + [
        "--timesteps", "3", "--ckpt-dir", str(tmp / "port3")])
    return out


def manifest(root, step):
    with open(os.path.join(root, "timeseries", f"step_{step:09d}",
                           "manifest.json")) as f:
        return json.load(f)


def test_cli_matches_reference(cli):
    (jcalls, jtext), (tcalls, ttext) = cli["ref2"], cli["port2"]
    for text in (jtext, ttext):
        assert "timestep 0: cold start" in text, text
        assert "timestep 1: warm-start from timestep 0 (step 3)" in text
        assert "no init probe" in text and "timestep 1 PSNR" in text, text
    assert [c["warm"] for c in tcalls] == [c["warm"] for c in jcalls] == \
        [False, True]
    # a warm-started timestep makes no initial tier probe, in both
    assert [c["probes"] for c in tcalls] == [c["probes"] for c in jcalls] \
        == [1, 0]
    np.testing.assert_allclose(tcalls[0]["losses"], jcalls[0]["losses"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert len(tcalls[1]["losses"]) == len(jcalls[1]["losses"]) == 3
    assert np.isfinite(tcalls[1]["losses"]).all()
    root_j, root_t = cli["dir"] / "ref2", cli["dir"] / "port2"
    assert CheckpointManager(str(root_t / "timeseries"), keep=0) \
        .all_steps() == [3, 6]
    for step in (3, 6):
        mj, mt = manifest(root_j, step), manifest(root_t, step)
        assert mt["extra"] == mj["extra"], step
        assert mt["treedef"] == mj["treedef"]
        assert [(m["shape"], m["dtype"]) for m in mt["leaves"]] == \
            [(m["shape"], m["dtype"]) for m in mj["leaves"]]
        assert ("delta" in mt) == ("delta" in mj) == (step == 6)
    assert manifest(root_t, 6)["delta"]["base_step"] == 3
    assert manifest(root_t, 6)["extra"]["timestep"] == 1
    extra_j = JCkpt(str(root_j / "merged"), keep=0).manifest_extra(6)
    extra_t = JCkpt(str(root_t / "merged"), keep=0).manifest_extra(6)
    assert extra_t == extra_j
    assert extra_t["timestep"] == 1 and extra_t["t"] == 0.1


def _leaves(root, step, sub):
    d = os.path.join(root, sub, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        n = json.load(f)["n_leaves"]
    return [np.load(os.path.join(d, f"arr_{i:06d}.npy")) for i in range(n)]


def test_cli_merge_tail_on_reference_chain(cli):
    """On the reference's complete chain the port restores the final
    timestep through ``restore_delta``, skips to the merge and writes the
    reference's merged checkpoint bit for bit and its final render at
    1e-5."""
    calls, text = cli["merge"]
    assert calls == []
    assert "chain already complete at timestep 1; skipping to merge" in text
    ref, got = cli["dir"] / "ref2", cli["dir"] / "merge"
    for a, b in zip(_leaves(got, 6, "merged"), _leaves(ref, 6, "merged")):
        np.testing.assert_array_equal(a, b)
    assert JCkpt(str(got / "merged"), keep=0).manifest_extra(6) == \
        JCkpt(str(ref / "merged"), keep=0).manifest_extra(6)
    np.testing.assert_allclose(np.load(got / "render_final.npy"),
                               np.load(ref / "render_final.npy"),
                               rtol=IMG_TOL, atol=IMG_TOL)


def test_cli_continues_reference_chain(cli):
    """A chain the reference wrote for 2 timesteps, continued to 3 by the
    port and by the reference: both restart at timestep 2 from the same
    restored state and schedule, with no probe, and their first step's
    loss agrees at the distributed trainer's gate; the new delta's extras
    and base are the reference's."""
    (jcalls, jtext), (tcalls, ttext) = cli["ref3"], cli["port3"]
    for text in (jtext, ttext):
        assert "restarting at timestep 2 (chain committed through step 6)" \
            in text, text
        assert "timestep 2: warm-start from timestep 1 (step 6)" in text
    assert [c["probes"] for c in tcalls] == [c["probes"] for c in jcalls] \
        == [0]
    np.testing.assert_allclose(tcalls[0]["losses"][0],
                               jcalls[0]["losses"][0], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert np.isfinite(tcalls[0]["losses"]).all()
    mj = manifest(cli["dir"] / "ref3", 9)
    mt = manifest(cli["dir"] / "port3", 9)
    assert mt["extra"] == mj["extra"] and mt["extra"]["timestep"] == 2
    assert mt["delta"]["base_step"] == mj["delta"]["base_step"] == 6


@pytest.fixture(scope="module")
def densify_runs(tmp_path_factory):
    """The port alone, with densify and a binding cap: ``--timesteps 2``
    then ``3`` (and ``3`` again) in one directory, and 3 uninterrupted."""
    tmp = tmp_path_factory.mktemp("ts_densify")
    flags = FLAGS + ["--densify-every", "2", "--densify-from", "1",
                     "--densify-cap", "1300"]
    a, b = str(tmp / "split"), str(tmp / "whole")
    # the CPU scatter-adds sum in thread order, which moves a loss by an
    # ulp from run to run; deterministic algorithms fix the order, so the
    # restart is held bit for bit
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return {
            "split": [run_port(flags + ["--timesteps", str(n),
                                        "--ckpt-dir", a])
                      for n in (2, 3, 3)],
            "whole": run_port(flags + ["--timesteps", "3", "--ckpt-dir", b]),
            "dirs": (a, b),
        }
    finally:
        torch.use_deterministic_algorithms(was)


def test_cli_restart_equals_uninterrupted(densify_runs):
    (c2, _), (c3, t3), (c_done, t_done) = densify_runs["split"]
    whole, _ = densify_runs["whole"]
    assert "restarting at timestep 2" in t3, t3
    assert [c["probes"] for c in c3] == [1]      # the densify re-probe only
    split = [c["losses"] for c in c2 + c3]
    assert split == [c["losses"] for c in whole]     # bit for bit
    # the final states, through each chain's delta restore
    a, b = densify_runs["dirs"]
    like = None
    trees = []
    for root in (a, b):
        ck = CheckpointManager(os.path.join(root, "timeseries"), keep=0)
        if like is None:
            arrs = _leaves(root, 3, "timeseries")
            like = [torch.from_numpy(x) for x in arrs]
        trees.append(ck.restore_delta(9, like, device="cpu")[0])
    names = ("means", "log_scales", "quats", "opacity_logit", "colors",
             "active", "owner")
    for i, name in enumerate(names):
        x, y = trees[0][i].numpy(), trees[1][i].numpy()
        if name in TRAINED:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(x, y)
    # the cap, not the capacity, bounds the live splats (the t = 0 state,
    # 1.1K live a partition, grows to it)
    live = trees[0][5].numpy().sum(1)
    assert trees[0][5].shape[1] > 1300 and (live <= 1300).all()
    assert (_leaves(a, 3, "timeseries")[5].sum(1) == 1300).all()
    assert c_done == []
    assert "chain already complete at timestep 2; skipping to merge" \
        in t_done
