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


def from_numpy_tree(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, device=dev)
        return torch.tensor(a.astype(np.float32), device=dev).to(cfg.pdtype)

    return conv(tree)


def to_numpy_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The reverse copy, as float32 numpy (for fixtures and tests)."""
    if isinstance(params, dict):
        return {k: to_numpy_tree(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict → ``{"a/b/c": leaf}`` (the ``.npz`` fixture layout)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flatten``."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
