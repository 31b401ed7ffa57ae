"""The paper's second scene, Rayleigh–Taylor, through both packages' GS
training CLI on the CPU: its ``cpu`` tier (12,000 points of the perturbed
interface; 11,757 extracted), 4 partitions, 64x64, 16 views, one view a
step, three passes over the views (48 steps: no densify event, whose
vmapped split the reference cannot run under jax 0.9), the schedule the
four-card run of the ``full`` tier used.  The port's per-step losses equal
the reference's at the distributed trainer's tolerances (rtol 1e-5, atol
1e-6: ``tests/test_torch_distributed.py``), so each pass's mean loss does
too; ``-s`` prints both packages' pass means.  The reference runs in a
subprocess of its own (its host-device count is fixed when JAX starts)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
VIEWS, PASSES = 16, 3
FLAGS = ["--gs", "--dataset", "rayleigh_taylor", "--parts", "4",
         "--resolution", "64", "--views", str(VIEWS), "--steps",
         str(VIEWS * PASSES), "--densify-every", "10", "--densify-from", "60"]
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
#: the reference's run (JAX compiles every tier's step) takes ~35 s here
RUN_TIMEOUT_S = 300

#: the reference's CLI with ``fit_partitions``' losses printed as JSON
REF_SCRIPT = """
import json, sys
import repro.core.distributed as d
import repro.launch.train as t
real, losses = d.fit_partitions, []
def fit(*a, **k):
    out = real(*a, **k)
    losses.extend(float(x) for x in out[2])
    return out
d.fit_partitions = fit
sys.argv = ["train"] + sys.argv[1:]
t.main()
print("LOSSES " + json.dumps(losses))
"""


def test_rayleigh_taylor_passes_match_reference(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT] + FLAGS
        + ["--ckpt-dir", str(tmp_path / "ref")], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert train.main(FLAGS + ["--device", "cpu", "--ckpt-dir",
                                       str(tmp_path / "port")]) == 0
        out, err = ref.communicate(timeout=RUN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, (out[-3000:], err[-4000:])
    want = np.asarray(json.loads(
        [ln for ln in out.splitlines() if ln.startswith("LOSSES ")][0][7:]))
    rec = train.read_record(buf.getvalue(), "[train-gs]")
    got = np.asarray(rec["losses"])
    assert rec["points"] == 11757 and rec["slots"][0] == 4
    assert got.shape == want.shape == (VIEWS * PASSES,)
    for tag, x in (("port", got), ("reference", want)):
        print(f"rayleigh_taylor cpu tier, mean loss of each pass over the "
              f"{VIEWS} views, {tag}: "
              f"{x.reshape(PASSES, VIEWS).mean(1).tolist()}")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
