"""The port's LM train step against the reference's for the SMOKE archs of
the other families -- MoE, SSM, hybrid, encoder-decoder and VLM -- as
``test_torch_lm_train.py`` holds the dense ones (``_torch_lm``: two float32
steps, one jitted reference function each).  jamba's A_log moments are
the one exemption, with its source shown in
``test_torch_lm_train_opts.py``.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_lm  # noqa: E402
from repro.configs import ALIASES  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402

MIXED = [a for a in ALIASES if ref_get_smoke(a).family != "dense"]


@pytest.mark.parametrize("arch", MIXED)
def test_two_train_steps_match_reference(arch):
    _torch_lm.check_two_steps(arch)
