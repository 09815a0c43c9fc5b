"""Weight bridge: the JAX package's parameters → the port's.

The JAX params tree, exported as numpy (``jax.tree.map(np.asarray,
params)``), has the same nested names and stacked ``[L, ...]`` layouts as
the port's, so the copy is one-to-one.  Floating leaves go through float32
(a bf16 leaf arrives as ``ml_dtypes.bfloat16``, which torch cannot take
directly) and then to the config's parameter dtype — lossless for bf16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import F32_LEAVES
from repro_torch.tree import unflatten as unflatten_paths


def from_numpy_tree(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    dev = resolve_device(device)

    def conv(a, dtype):
        if isinstance(a, dict):
            return {k: conv(v, torch.float32 if k in F32_LEAVES else dtype)
                    for k, v in a.items()}
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, device=dev)
        return torch.tensor(a.astype(np.float32), device=dev).to(dtype)

    return conv(tree, cfg.pdtype)


def to_numpy_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The reverse copy, as float32 numpy (for fixtures and tests)."""
    if isinstance(params, dict):
        return {k: to_numpy_tree(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` (the ``.npz`` fixture's keys) → the nested
    dict.  The keys are read as dict paths and rebuilt by ``tree``'s
    walker, the one the checkpoints use."""
    return unflatten_paths(
        [("".join(f"[{k!r}]" for k in path.split("/")), v)
         for path, v in flat.items()], {})
