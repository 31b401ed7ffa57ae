"""The port's LM train step (``models.steps.make_train_step``: the loss,
the backward through remat and the flash VJP, AdamW under the schedule)
against the reference's, for the SMOKE archs of the dense family (oracle
``tests/test_smoke_archs.py:45``, ``:65``): two steps in float32 from the
reference's ``init_params(PRNGKey(0))`` on seeded numpy batches (B 2, S 64,
kv_chunk 32, total_steps 10), bounds in ``_torch_lm``; and the spec trees.
The other families are in ``test_torch_lm_train_mixed.py`` (two files, so
xdist's ``loadfile`` spreads them), the variants (microbatches, int8
compression, bf16) in ``test_torch_lm_train_opts.py``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm  # noqa: E402
from repro.configs import ALIASES  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402

DENSE = [a for a in ALIASES if ref_get_smoke(a).family == "dense"]


@pytest.mark.parametrize("arch", DENSE)
def test_two_train_steps_match_reference(arch):
    _torch_lm.check_two_steps(arch)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_specs_match_reference(compression):
    """``opt_state_specs`` and ``input_specs`` (``meta`` tensors) against
    the reference's ``ShapeDtypeStruct`` trees, every arch and shape cell:
    the same leaves in the same order, shapes and dtypes."""
    from repro.configs import get_spec as ref_get_spec
    from repro.models import TrainCfg as RefTrainCfg
    from repro.models import SHAPES as REF_SHAPES
    from repro.models import input_specs as ref_input_specs
    from repro.models import opt_state_specs as ref_opt_state_specs
    from repro_torch.configs import get_spec
    from repro_torch.models import SHAPES, TrainCfg, input_specs, opt_state_specs
    from repro_torch.runtime.checkpoint import tree_flatten

    assert SHAPES == REF_SHAPES

    def same(got, want):
        g, gdef = tree_flatten(got)
        w, wdef = jax.tree.flatten(want)
        assert str(gdef) == str(wdef)
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)

    for arch in ALIASES:
        spec, rspec = get_spec(arch), ref_get_spec(arch)
        same(opt_state_specs(spec, TrainCfg(compression=compression)),
             ref_opt_state_specs(rspec, RefTrainCfg(compression=compression)))
        if compression == "none":
            for shape in SHAPES:
                same(input_specs(spec, shape), ref_input_specs(rspec, shape))
