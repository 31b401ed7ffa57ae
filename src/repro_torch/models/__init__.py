"""The LM models of the port: specs, parameters, layers, the decoder and the
serve steps (the serving half of ``repro.models``)."""

from repro_torch.models.spec import ModelSpec, MoECfg, SSMCfg
from repro_torch.models.params import (
    init_params,
    param_defs,
    param_specs,
    params_from_numpy,
)
from repro_torch.models.steps import (
    cache_len,
    cache_specs,
    make_decode_step,
    make_prefill_step,
    zeros_caches,
)
