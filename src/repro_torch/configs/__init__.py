"""Config registry: ``get_config("mamba2-2.7b")`` → ModelConfig.

Same names as ``repro.configs``; architectures the port has not reached
raise ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced  # re-export

_MODULES = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

# registered in ``repro.configs`` but not ported yet (ROADMAP Queue A item 11)
_NOT_PORTED = ("chameleon-34b", "nemotron-4-340b", "command-r-35b",
               "gemma-2b", "hubert-xlarge", "deepseek-v2-236b",
               "mixtral-8x7b", "edge-cv-heavy", "edge-stream-light")


def get_config(name: str) -> ModelConfig:
    if name in _NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet "
                       "(ROADMAP Queue A item 11)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced_config(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)
