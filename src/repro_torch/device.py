"""Device selection shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU.  With no
GPU and no explicit CPU request they raise: a silent CPU fallback would
report CPU timings under the GPU's name.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no GPU present raises.
    The CUDA index is filled in (``cuda`` → ``cuda:<current>``), so that two
    handles naming one card compare equal, as a tensor's device does: the
    control plane keys images and adopts probe builds by it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a, b) -> bool:
    """Whether two placement handles (``None``, a string or a
    ``torch.device``) name the same device; ``None`` names none."""
    if a is None or b is None:
        return a is b
    return resolve_device(a) == resolve_device(b)
