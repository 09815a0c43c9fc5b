"""Build and load the CUDA kernels of ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The libraries go into ``build/kernels/`` at the root
of the checkout, named by a hash of the source, the shared ``*.cuh``
headers and the flags, so a changed source rebuilds and an unchanged one
is reused.  ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and the
machine they run on has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build or to launch.  Callers that
    degrade gracefully on other errors (the speculative draft) let this one
    through: it is a fault of the build or the card, not of the input."""


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels build only on a "
                      "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    key = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        key.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent build sees all or none
    return log


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel (default: all of ``csrc``) in parallel
    and return each one's compiler log (empty when it was already built)."""
    names = list(names or kernel_names())
    procs = {n: _start(n) for n in names}
    logs = {}
    try:
        for n, p in procs.items():
            logs[n] = "" if p is None else _finish(n, p)
    finally:
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
