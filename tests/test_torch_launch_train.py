"""The port's training CLI, ``python -m repro_torch.launch.train --gs``, on
the CPU: at world size 1 (one process, an in-process group) and on 4 gloo
ranks, each run twice (``--steps 2``, then ``--steps 3`` resuming from the
checkpoint), as ``tests/test_distributed.py`` runs the reference's CLI.
The merged checkpoint it writes serves through both packages'
``GSRenderServer.from_checkpoint`` and their images agree at 1e-5 (the
serving slice's image gate).  Under ``--exchange`` (and on 4 ranks
``--rebalance-every 2``) the same two runs resume the checkpointed budget
without a probe, ``--exchange-budget`` pins it, and the budget the port
records equals the one the reference's CLI records for the same flags."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import _torch_dist_ranks as ranks  # noqa: E402
from repro.core import cameras as jc  # noqa: E402
from repro.core import serving as js  # noqa: E402
from repro.runtime import CheckpointManager as JCkpt  # noqa: E402
from repro_torch.core import cameras as tc  # noqa: E402
from repro_torch.core import serving as ts  # noqa: E402
from repro_torch.launch import train  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
IMG_TOL = 1e-5
#: each CLI run's wall limit (a smoke run takes a few seconds)
RUN_TIMEOUT_S = 180


def run_world1(ckpt_dir, steps):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--gs", "--smoke",
         "--device", "cpu", "--ckpt-dir", str(ckpt_dir), "--steps",
         str(steps)], env=env, capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out.stdout


def run_world4(tmp_path, ckpt_dir, steps):
    log = str(tmp_path / f"cli4_{steps}")
    argv = ["--gs", "--smoke", "--device", "cpu", "--ckpt-dir",
            str(ckpt_dir), "--steps", str(steps)]
    _torch_dist.run_ranks(ranks.cli_rank, (4, 1), tmp_path, argv, log,
                          timeout=RUN_TIMEOUT_S)
    with open(f"{log}.0") as f:
        text = f.read()
    for r in (1, 2, 3):
        with open(f"{log}.{r}") as f:
            assert f.read() == "", f"rank {r} printed"
    return text


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    out = {}
    for world, run in ((1, lambda d, s: run_world1(d, s)),
                       (4, lambda d, s: run_world4(tmp, d, s))):
        d = tmp / f"w{world}"
        out[world] = (d, run(d, 2), run(d, 3))
    return out


@pytest.mark.parametrize("world", [1, 4])
def test_cli_trains_and_resumes(cli_runs, world):
    d, first, second = cli_runs[world]
    mesh = "mesh=1x1" if world == 1 else "mesh=2x2"
    for text in (first, second):
        assert "raster=tiered" in text, text
        assert mesh in text, text
        assert "PSNR" in text, text
    assert "resuming from checkpoint step 2" not in first
    assert "resuming from checkpoint step 2" in second
    assert "trained steps 2->3 (1 ran" in second
    assert os.path.exists(d / "render_final.npy")
    # the driver's own checkpoints, the per-partition ones, the merged one
    assert JCkpt(str(d), keep=0).all_steps() == [2, 3]
    for pid in (0, 1):
        assert JCkpt(str(d / "partitions"), keep=0).latest_restorable_step(
            partition=pid) == 3
    assert JCkpt(str(d / "merged"), keep=0).latest_restorable_step() == 3


@pytest.mark.parametrize("world", [1, 4])
def test_cli_merged_checkpoint_serves_in_both_packages(cli_runs, world):
    d = str(cli_runs[world][0])
    jserver, jextra = js.GSRenderServer.from_checkpoint(d, max_batch=4)
    tserver, textra = ts.GSRenderServer.from_checkpoint(d, device="cpu",
                                                        max_batch=4)
    assert textra == jextra
    scene = textra["scene"]
    assert scene["dataset"] == "sphere_shell" and scene["resolution"] == 32
    res, center, r = scene["resolution"], scene["center"], scene["radius"]
    jrig = jc.orbital_rig(3, center, r, width=res, height=res)
    trig = tc.orbital_rig(3, center, r, width=res, height=res, device="cpu")
    served = list(zip(jserver.serve(jrig), tserver.serve(trig)))
    assert len(served) == 3
    for jr, tr in served:
        np.testing.assert_allclose(tr.rgb, jr.rgb, rtol=IMG_TOL, atol=IMG_TOL)
    # the final render the trainer saved is the merged model's own render
    final = np.load(os.path.join(d, "render_final.npy"))
    assert final.shape == (4, res, res, 3) and np.isfinite(final).all()


@pytest.mark.parametrize("flag,item", [
    (["--exchange"], "item 18"), (["--rebalance-every", "2"], "item 18"),
    (["--dtype-policy", "bf16"], "item 12"),
    (["--grad-compress", "int8"], "item 12"), (["--timeseries"], "item 15")])
def test_unported_flags_exit_naming_their_item(flag, item, capsys,
                                              tmp_path):
    """Items 18's, 12's and 15's flags are accepted: a one-step ``--smoke``
    run trains under them and records them in its checkpoint
    (``extra["exchange"]``: the exchange's budget state, None without
    ``--exchange``; ``--timeseries``: a chain of two one-step timesteps,
    timestep 1 a delta on timestep 0)."""
    if item == "item 18":
        argv = ["--gs", "--smoke", "--device", "cpu", "--steps", "1",
                "--ckpt-dir", str(tmp_path)] + flag
        assert train.main(argv) == 0
        out = capsys.readouterr().out
        assert "PSNR" in out, out
        extra = JCkpt(str(tmp_path), keep=0).manifest_extra(1)
        if flag == ["--exchange"]:
            assert "table=exchange " in out, out
            assert extra["exchange"]["budget"] > 0, extra
        else:
            assert "table=all-gather " in out, out
            assert extra["exchange"] is None, extra
        return
    if item == "item 12":
        argv = ["--gs", "--smoke", "--device", "cpu", "--steps", "1",
                "--ckpt-dir", str(tmp_path)] + flag
        assert train.main(argv) == 0
        out = capsys.readouterr().out
        shown = {"--dtype-policy": "dtype=",
                 "--grad-compress": "grad-compress="}[flag[0]] + flag[1]
        assert shown in out and "PSNR" in out, out
        extra = JCkpt(str(tmp_path), keep=0).manifest_extra(1)
        assert extra[flag[0][2:].replace("-", "_")] == flag[1], extra
        return
    argv = ["--gs", "--smoke", "--device", "cpu", "--steps", "1",
            "--ckpt-dir", str(tmp_path)] + flag
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "timestep 0: cold start" in out and "PSNR" in out, out
    assert "timestep 1: warm-start from timestep 0 (step 1)" in out, out
    chain = JCkpt(str(tmp_path / "timeseries"), keep=0)
    assert chain.all_steps() == [1, 2]
    assert chain.manifest_extra(2)["timestep"] == 1
    with open(tmp_path / "timeseries" / "step_000000002" /
              "manifest.json") as f:
        assert json.load(f)["delta"]["base_step"] == 1


# ---------------------------------------------------------------------------
# --exchange, --exchange-budget, --rebalance-every
# ---------------------------------------------------------------------------


#: the reference CLI takes no densify step here: jax 0.9 raises in its
#: densify (ROADMAP queue 3)
REF_FLAGS = ["--gs", "--smoke", "--exchange", "--steps", "1",
             "--densify-every", "100", "--densify-from", "100"]


def _counted_main(argv):
    """``train.main(argv)`` in this process -> (exit code, the calls of
    ``probe_gs_exchange``, what it printed)."""
    import contextlib
    import io

    from repro_torch.core import distributed as D

    calls = []
    real = D.probe_gs_exchange

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    D.probe_gs_exchange = counted
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            rc = train.main(argv)
        return rc, len(calls), text.getvalue()
    finally:
        D.probe_gs_exchange = real


@pytest.fixture(scope="module")
def ex_runs(tmp_path_factory):
    """The exchange CLI runs: the reference's CLI (a subprocess) and the
    4-rank world start first; the world-1 runs go in this process."""
    tmp = tmp_path_factory.mktemp("cli_ex")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train"] + REF_FLAGS
        + ["--ckpt-dir", str(tmp / "ref")], env=env, cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    d4 = tmp / "w4"
    log = str(tmp / "cli4")
    argv4 = ["--gs", "--smoke", "--device", "cpu", "--exchange",
             "--rebalance-every", "2", "--ckpt-dir", str(d4)]
    w4 = _torch_dist.Ranks(ranks.jobs_rank, (4, 1), tmp, [
        ("cli_probe_rank", (argv4 + ["--steps", "2"], f"{log}_a")),
        ("cli_probe_rank", (argv4 + ["--steps", "3"], f"{log}_b"))],
        timeout=RUN_TIMEOUT_S)
    out = {}
    try:
        d1 = tmp / "w1"
        for tag, flags in (("w1", ["--exchange"]),
                           ("pin", ["--exchange", "--exchange-budget",
                                    "4096", "--steps", "1"]),
                           ("port", REF_FLAGS[2:])):
            root = d1 if tag == "w1" else tmp / tag
            runs = [["--steps", "2"], ["--steps", "3"]] if tag == "w1" \
                else [[]]
            for extra in runs:
                argv = ["--gs", "--smoke", "--device", "cpu", "--ckpt-dir",
                        str(root)] + flags + extra
                out.setdefault(tag, []).append(_counted_main(argv))
            out[f"{tag}_dir"] = root
    finally:
        w4.join()
        stdout, stderr = ref.communicate(timeout=RUN_TIMEOUT_S)
    assert ref.returncode == 0, (stdout[-2000:], stderr[-3000:])
    out["ref_dir"] = tmp / "ref"
    out["w4"] = []
    for run in ("a", "b"):
        with open(f"{log}_{run}.0") as f:
            text = f.read()
        probes = []
        for r in range(4):
            with open(f"{log}_{run}.probes{r}") as f:
                probes.append(int(f.read()))
        out["w4"].append((text, probes))
    out["w4_dir"] = d4
    return out


def _exchange_extra(root, step):
    return JCkpt(str(root), keep=0).manifest_extra(step)["exchange"]


@pytest.mark.parametrize("world", [1, 4])
def test_cli_exchange_trains_and_resumes_without_probe(ex_runs, world):
    """``--exchange`` trains 2 steps (the budget probed: on 4 ranks a 2x2
    per-edge matrix, grown after densify from the in-step demand), then a
    second call resumes at step 2 with the checkpointed budget and calls
    the probe on no rank."""
    if world == 1:
        (rc1, p1, t1), (rc2, p2, t2) = ex_runs["w1"]
        assert rc1 == rc2 == 0
        probes1, probes2 = [p1], [p2]
    else:
        (t1, probes1), (t2, probes2) = ex_runs["w4"]
    for text in (t1, t2):
        assert f"mesh={'2x2' if world == 4 else '1x1'}" in text, text
        assert "table=exchange " in text and "PSNR" in text, text
    assert "resuming from checkpoint step 2" in t2, t2
    assert "trained steps 2->3 (1 ran" in t2, t2
    assert min(probes1) >= 1 and max(probes2) == 0, (probes1, probes2)
    root = ex_runs[f"w{world}_dir"]
    b2 = np.asarray(_exchange_extra(root, 2)["budget"])
    b3 = np.asarray(_exchange_extra(root, 3)["budget"])
    assert b2.ndim == (2 if world == 4 else 0)
    assert (b3 >= b2).all() and (b2 >= 1).all(), (b2, b3)


def test_cli_exchange_budget_pins(ex_runs):
    """``--exchange-budget 4096`` is the budget: printed in the table
    kind, never probed, recorded as is."""
    (rc, probes, text), = ex_runs["pin"]
    assert rc == 0 and probes == 0
    assert "table=exchange(budget=4096) " in text, text
    assert _exchange_extra(ex_runs["pin_dir"], 1)["budget"] == 4096


def test_cli_exchange_extra_matches_reference(ex_runs):
    """The port's ``extra["exchange"]`` is the reference CLI's for the
    same flags, JSON for JSON."""
    (rc, probes, _), = ex_runs["port"]
    assert rc == 0 and probes == 1
    got = _exchange_extra(ex_runs["port_dir"], 1)
    want = _exchange_extra(ex_runs["ref_dir"], 1)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
