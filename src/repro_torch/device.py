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
    """``None`` means ``cuda``; a CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
