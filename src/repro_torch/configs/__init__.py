"""Config registry: ``get_config("mamba2-2.7b")`` → ModelConfig.

Same names as ``repro.configs``, every one of them ported; an unknown
name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced  # re-export

_MODULES = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    # the paper's own workload pair (heavy CV-analogue / light stream)
    "edge-cv-heavy": "repro_torch.configs.edge_paper",
    "edge-stream-light": "repro_torch.configs.edge_paper",
}

_ATTR = {"edge-cv-heavy": "CV_HEAVY", "edge-stream-light": "STREAM_LIGHT"}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return getattr(importlib.import_module(_MODULES[name]),
                   _ATTR.get(name, "CONFIG"))


def get_reduced_config(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)
