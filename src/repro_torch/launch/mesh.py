"""Device meshes, as ``repro.launch.mesh``.

Mesh axes:
  single-pod : (16, 16)      = ("data", "model")         — 256 ranks
  multi-pod  : (2, 16, 16)   = ("pod", "data", "model")  — 512 ranks
``pod`` composes with ``data`` for the batch/FSDP dimension.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over the process group, which the caller initialises first (one rank a
device; ``launch/train.py --distributed`` does it from torchrun's
environment).  A production mesh needs exactly its world size: these
functions never shrink a mesh to the ranks at hand.  ``LocalMesh`` is the
1 x 1 ``("data", "model")`` mesh of one device without a process group,
which a ``Trainer`` given a device runs on.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import resolve_device


class LocalMesh:
    """The 1 x 1 ``("data", "model")`` mesh on one device, with no process
    group: every collective over it is the identity."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.device_type = self.device.type
        self.shape = {"data": 1, "model": 1}

    def __repr__(self) -> str:
        return f"LocalMesh({self.device})"


def _device_type(device) -> str:
    return resolve_device(device).type


def _make_mesh(shape, axes, device=None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if not (dist.is_available() and dist.is_initialized()) or have != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} {axes} mesh needs a process "
            f"group of world size {need}; "
            + (f"this one has world size {have}" if dist.is_initialized()
               else "no process group is initialised (launch with "
                    "torchrun and --distributed)"))
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_test_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh over the process group's ranks."""
    return _make_mesh((data, model), ("data", "model"), device)


def mesh_num_chips(mesh) -> int:
    if isinstance(mesh, LocalMesh):
        return 1
    return int(math.prod(tuple(mesh.mesh.shape)))


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if isinstance(mesh, LocalMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return resolve_device("cuda")
    return torch.device(mesh.device_type)


def as_mesh(mesh_or_device: Optional[object]):
    """A mesh as given, or a device (``None`` meaning the card) as its
    ``LocalMesh``."""
    if mesh_or_device is None or isinstance(mesh_or_device,
                                            (str, torch.device)):
        return LocalMesh(mesh_or_device)
    return mesh_or_device
