"""Atomic, async-capable checkpointing (numpy + JSON manifest), with the
on-disk layout of ``repro.checkpointing.checkpoint``:

    <dir>/step_000000123/
        manifest.json         — index {key, volume, path, shape, dtype}
        shard_<i>.npz         — flat leaf arrays (volumes of at most 2 GiB)
    <dir>/step_000000123.COMMIT  — atomicity marker, written last

A checkpoint without its COMMIT marker is ignored (a writer died
mid-save) and garbage-collected on a later save.  bfloat16 leaves are
stored as raw bytes and read back by viewing the bytes as
``torch.bfloat16``.  The port has no JAX treedef: it rebuilds the tree
from each entry's ``path`` (JAX's ``keystr`` form), so it restores
checkpoints written by the JAX package, parameters and optimizer state
alike.  Its own manifests carry no ``treedef``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import QuantMoment
from repro_torch.tree import flatten_with_path, unflatten

_VOLUME_BYTES = 2 << 30
_NAMEDTUPLES = {QuantMoment._fields: QuantMoment}
_RAW = {"bfloat16": torch.bfloat16}     # stored as bytes (no numpy dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _encode(leaf) -> Tuple[np.ndarray, str, List[int]]:
    """A leaf as (npz-safe array, dtype name, shape): host copy of a
    tensor, bfloat16 as raw bytes."""
    t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
    name = _dtype_name(t.dtype)
    if name in _RAW:
        return t.reshape(-1).view(torch.uint8).numpy(), name, list(t.shape)
    return t.numpy(), name, list(t.shape)


def _decode(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype in _RAW:
        flat = torch.from_numpy(np.ascontiguousarray(raw).reshape(-1))
        return flat.view(_RAW[dtype]).reshape(shape)
    return torch.from_numpy(np.asarray(raw).reshape(shape))


def _snapshot(tree) -> List[Tuple[str, np.ndarray, str, List[int]]]:
    return [(path, *_encode(leaf)) for path, leaf in flatten_with_path(tree)]


def save(ckpt_dir: str, step: int, tree: Any,
         extra_meta: Optional[Dict] = None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    return _write(ckpt_dir, step, _snapshot(tree), extra_meta)


def _write(ckpt_dir, step, snapshot, extra_meta) -> str:
    name = f"step_{step:09d}"
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    volumes: List[Dict[str, np.ndarray]] = [{}]
    vol_bytes = 0
    index = []
    for i, (path, arr, dtype, shape) in enumerate(snapshot):
        key = f"leaf_{i}"
        if vol_bytes > 0 and vol_bytes + arr.nbytes > _VOLUME_BYTES:
            volumes.append({})
            vol_bytes = 0
        volumes[-1][key] = arr
        vol_bytes += arr.nbytes
        index.append({"key": key, "volume": len(volumes) - 1, "path": path,
                      "shape": shape, "dtype": dtype})

    for vi, vol in enumerate(volumes):
        np.savez(os.path.join(tmp, f"shard_{vi}.npz"), **vol)
    manifest = {"step": step, "index": index, "time": time.time(),
                "extra": extra_meta or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(final + ".COMMIT", "w") as f:
        f.write(name)
    return final


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a background
    thread; one write outstanding (``save`` and ``wait`` join the last)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra_meta: Optional[Dict] = None):
        self.wait()
        snapshot = _snapshot(tree)              # device → host, now

        def work():
            try:
                _write(self.ckpt_dir, step, snapshot, extra_meta)
                self.gc()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def gc(self):
        steps = committed_steps(self.ckpt_dir)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            name = f"step_{s:09d}"
            shutil.rmtree(os.path.join(self.ckpt_dir, name),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.ckpt_dir, name + ".COMMIT"))
            except OSError:
                pass
        # sweep uncommitted debris older than a minute
        for entry in os.listdir(self.ckpt_dir):
            m = re.fullmatch(r"step_(\d+)(\.tmp)?", entry)
            if not m:
                continue
            s = int(m.group(1))
            committed = os.path.exists(
                os.path.join(self.ckpt_dir, f"step_{s:09d}.COMMIT"))
            if m.group(2) or not committed:
                full = os.path.join(self.ckpt_dir, entry)
                if time.time() - os.path.getmtime(full) > 60:
                    shutil.rmtree(full, ignore_errors=True)


def committed_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for entry in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.COMMIT", entry)
        if m and os.path.isdir(os.path.join(
                ckpt_dir, f"step_{int(m.group(1)):09d}")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, device="cpu",
            target_tree: Any = None):
    """Load a committed checkpoint (the latest when ``step`` is None) as
    a tree of tensors on ``device``.  ``target_tree``: a tree whose leaf
    paths the checkpoint's must equal (``ValueError`` otherwise).
    Returns ``(tree, manifest_extra)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if not os.path.exists(final + ".COMMIT"):
        raise FileNotFoundError(f"checkpoint {final} lacks COMMIT marker")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)

    if target_tree is not None:
        want = [p for p, _ in flatten_with_path(target_tree)]
        got = [item["path"] for item in manifest["index"]]
        if want != got:
            raise ValueError(f"checkpoint tree mismatch: {got} != {want}")
    volumes: Dict[int, Any] = {}
    items = []
    try:
        for item in manifest["index"]:
            vi = item["volume"]
            if vi not in volumes:
                volumes[vi] = np.load(os.path.join(final, f"shard_{vi}.npz"))
            leaf = _decode(volumes[vi][item["key"]], item["dtype"],
                           item["shape"])
            items.append((item["path"], leaf.to(device)))
    finally:
        for v in volumes.values():
            v.close()
    return unflatten(items, _NAMEDTUPLES), manifest.get("extra", {})
