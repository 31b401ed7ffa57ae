"""Configurations of the port: the GS datasets (``get_gs_dataset``) and the
architecture registry, ``get_spec("<id>")`` / ``get_smoke("<id>")``.

Each ``configs/<id>.py`` exports SPEC (exact published config) and SMOKE (a
reduced same-family config for CPU tests), copied from the reference's.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.gs_datasets import get_gs_dataset

ARCHS = (
    "minicpm_2b",
    "h2o_danube_1_8b",
    "qwen1_5_4b",
    "codeqwen1_5_7b",
    "llama4_maverick_400b_a17b",
    "mixtral_8x22b",
    "mamba2_780m",
    "jamba_v0_1_52b",
    "whisper_tiny",
    "paligemma_3b",
)

#: canonical assignment ids -> module names
ALIASES = {
    "minicpm-2b": "minicpm_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-780m": "mamba2_780m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-tiny": "whisper_tiny",
    "paligemma-3b": "paligemma_3b",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_spec(arch: str):
    return _module(arch).SPEC


def get_smoke(arch: str):
    return _module(arch).SMOKE


def all_arch_ids():
    return list(ALIASES.keys())
