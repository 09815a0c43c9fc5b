"""Executable-image registry (≙ the container/unikernel image registry).

Caches ``ExecutableImage``s keyed by (name, argument shapes/dtypes/
devices, placement handle) so redeploys after failures or scale-ups don't
pay the capture again — the unikernel analogue of pulling a prebuilt
image instead of recompiling the app+libOS.  Two nodes whose handles name
one card share its images.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

from repro_torch.core.executor import ExecutableImage, arg_spec
from repro_torch.device import resolve_device


def _handle_fingerprint(mesh) -> Tuple:
    if mesh is None:
        return ()
    return (str(resolve_device(mesh)),)


def _args_fingerprint(args: Tuple) -> Tuple:
    return tuple((path, shape, str(dtype), str(device))
                 for path, shape, dtype, device in arg_spec(args))


class ImageRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._images: Dict[Tuple, ExecutableImage] = {}
        self.builds = 0
        self.hits = 0

    def get_or_build(self, name: str, fn: Callable, args: Tuple,
                     donate_argnums: Tuple[int, ...] = (),
                     in_shardings: Any = None, mesh=None) -> ExecutableImage:
        key = (name, _args_fingerprint(args), _handle_fingerprint(mesh))
        with self._lock:
            img = self._images.get(key)
            if img is not None:
                self.hits += 1
                return img
        img = ExecutableImage.build(name, fn, args,
                                    donate_argnums=donate_argnums,
                                    in_shardings=in_shardings, mesh=mesh)
        with self._lock:
            self._images[key] = img
            self.builds += 1
        return img

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"builds": self.builds, "hits": self.hits,
                    "images": len(self._images)}
