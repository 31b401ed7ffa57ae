"""The projection's dispatch on the CPU: ``project`` and its kernels'
module, without a card or ``nvcc``.

On CPU tensors ``project`` is the plain version (``project_ref``), bit for
bit, and no kernel launches; the kernels' module loads without building
anything.  The kernels themselves are held
against the plain version on the card (tests/test_torch_project_cuda.py);
the plain version against the JAX package in
``tests/test_torch_render.py::test_project_matches``.
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import projection as tp  # noqa: E402
from repro_torch.core.cameras import orbital_rig, select  # noqa: E402
from repro_torch.core.gaussians import from_points  # noqa: E402
from repro_torch.kernels import project as pk  # noqa: E402
from repro_torch.kernels import rasterize  # noqa: E402


def _scene():
    r = np.random.default_rng(0)
    g = from_points(r.uniform(0.2, 0.8, (64, 3)), capacity=80, device="cpu")
    g = g._replace(quats=torch.from_numpy(
        r.normal(size=(80, 4)).astype(np.float32)))
    return g, orbital_rig(3, (0.5, 0.5, 0.5), 0.7, width=32, height=24,
                          device="cpu")


def _no_build(*a, **k):
    raise AssertionError("the CPU path built or looked for a kernel")


@pytest.mark.parametrize("batched", [False, True])
def test_cpu_tensors_take_plain_version(monkeypatch, batched):
    monkeypatch.setattr(rasterize, "build", _no_build)
    monkeypatch.setattr(rasterize, "_nvcc", _no_build)
    g, rig = _scene()
    cam = rig if batched else select(rig, 1)
    launches = (pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES)
    tr = {k: p.clone().requires_grad_(True) for k, p in g.trainable().items()}
    got = tp.project(g.with_trainable(tr), cam)
    want = tp.project_ref(g, cam)
    for name in tp.Splats2D._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    (got.mean2d.sum() + got.cov2d.sum() + got.depth.sum()).backward()
    assert tr["means"].grad.abs().max() > 0
    assert (pk.PROJECT_LAUNCHES, pk.PROJECT_BWD_LAUNCHES) == launches


def test_kernel_module_imports_without_nvcc(monkeypatch):
    """A fresh copy of kernels/project.py loads with the build and the
    ``nvcc`` lookup refusing: nothing is built or bound at import."""
    monkeypatch.setattr(rasterize, "build", _no_build)
    monkeypatch.setattr(rasterize, "_nvcc", _no_build)
    spec = importlib.util.spec_from_file_location("_project_copy",
                                                  pk.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod._libs is None
    assert (mod.PROJECT_LAUNCHES, mod.PROJECT_BWD_LAUNCHES) == (0, 0)
    # and the kernels' wrappers refuse CPU tensors before any build
    g, rig = _scene()
    with pytest.raises(ValueError, match="CUDA"):
        mod.project_fwd(g.means, g.log_scales, g.quats,
                        torch.sigmoid(g.opacity_logit), g.active, rig.view,
                        rig.fx, rig.fy, width=32, height=24, near=0.05,
                        alpha_min=1 / 255)


@pytest.mark.parametrize("views", [False, True])
def test_project_rows_is_one_call_per_shard(monkeypatch, views):
    """``distributed._project_rows`` projects a (P, N) shard in one
    ``project`` call and lays the fields out as projecting each partition
    and stacking them would: (V, P, N, ...) with a view batch, (P, N, ...)
    without."""
    from repro_torch.core import distributed as D
    from repro_torch.core.gaussians import Gaussians

    g, rig = _scene()
    g2 = Gaussians(*(torch.stack([f, f.flip(0)]) for f in g))
    cam = rig if views else select(rig, 2)
    calls = []
    real = D.project
    monkeypatch.setattr(D, "project",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = D._project_rows(g2, cam, views)
    assert len(calls) == 1
    for name in tp.Splats2D._fields:
        want = torch.stack([getattr(tp.project(Gaussians(*(f[p] for f in g2)),
                                               cam), name) for p in range(2)],
                           dim=1 if views else 0)
        o = getattr(got, name)
        assert o.shape == want.shape, name
        torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-6, msg=name)
