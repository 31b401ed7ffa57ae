"""The port's training CLI, ``python -m repro_torch.launch.train --gs``, on
the CPU: at world size 1 (one process, an in-process group) and on 4 gloo
ranks, each run twice (``--steps 2``, then ``--steps 3`` resuming from the
checkpoint), as ``tests/test_distributed.py`` runs the reference's CLI.
The merged checkpoint it writes serves through both packages'
``GSRenderServer.from_checkpoint`` and their images agree at 1e-5 (the
serving slice's image gate)."""

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
    """Items 18 and 15 exit naming their item; item 12's flags are
    accepted: a one-step ``--smoke`` run trains under them and records
    them in its checkpoint."""
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
    assert train.main(["--gs", "--smoke", "--device", "cpu"] + flag) == 2
    assert item in capsys.readouterr().err
