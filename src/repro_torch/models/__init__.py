"""The LM models of the port: specs, parameters, layers, the decoder and the
train / serve steps (``repro.models``)."""

from repro_torch.models.spec import ModelSpec, MoECfg, SSMCfg
from repro_torch.models.params import (
    init_params,
    param_defs,
    param_specs,
    params_from_numpy,
)
from repro_torch.models.steps import (
    SHAPES,
    TrainCfg,
    cache_len,
    cache_specs,
    init_opt_state,
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    opt_state_specs,
    zeros_caches,
)
