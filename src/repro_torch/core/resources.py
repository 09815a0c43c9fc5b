"""Resource accounting per node (paper P3: resource-awareness).

The paper's manager watches CPU/RAM per Raspberry Pi; here the scarce
resources per node are device-memory bytes and sustained FLOP/s.  The
monitor tracks commitments (deployed executor footprints + in-flight work)
and answers admission queries.  Real telemetry plugs in through ``observe``;
tests drive it synthetically.

A node's default capacity is read from its card: the memory
``torch.cuda.get_device_properties`` reports, and the H100's dense bf16
tensor-core peak as its rate.  A node on the CPU has no card to read and
must be given its capacity.  (The field names keep the JAX package's
``hbm_bytes``, so specs, quotas and reports share one schema.)
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device

# NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet), the rate
# chip_smoke.py bounds the kernels with
FLOPS_PER_CARD = 989e12


def card_memory(device=None) -> int:
    """Bytes of memory on the card ``device`` names (default: the current
    CUDA device); a CPU device has none to read and raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"node on {dev}: a CPU node must be given its "
                         f"capacity (NodeCapacity(hbm_bytes=...))")
    return torch.cuda.get_device_properties(dev).total_memory


@dataclasses.dataclass
class NodeCapacity:
    chips: int = 1
    hbm_bytes: Optional[int] = None         # None → read from the card
    flops_per_s: float = FLOPS_PER_CARD

    def __post_init__(self):
        if self.hbm_bytes is None:
            self.hbm_bytes = self.chips * card_memory()


def host_capacity(device) -> Optional[NodeCapacity]:
    """What the entry points give a node on ``device``: ``None`` on the
    card (the node reads the card's memory), the host's memory on the CPU,
    which has no card to read."""
    if resolve_device(device).type == "cuda":
        return None
    return NodeCapacity(hbm_bytes=os.sysconf("SC_PAGE_SIZE")
                        * os.sysconf("SC_PHYS_PAGES"))


@dataclasses.dataclass
class Commitment:
    hbm_bytes: int
    flops_inflight: float = 0.0


class ResourceMonitor:
    def __init__(self):
        self._lock = threading.Lock()
        self.capacity: Dict[str, NodeCapacity] = {}
        self.committed: Dict[str, Dict[str, Commitment]] = {}

    def register_node(self, node_id: str, capacity: NodeCapacity):
        with self._lock:
            self.capacity[node_id] = capacity
            self.committed.setdefault(node_id, {})

    def unregister_node(self, node_id: str):
        with self._lock:
            self.capacity.pop(node_id, None)
            self.committed.pop(node_id, None)

    # ------------------------------------------------------------------
    def hbm_free(self, node_id: str) -> int:
        with self._lock:
            cap = self.capacity[node_id].hbm_bytes
            used = sum(c.hbm_bytes for c in self.committed[node_id].values())
            return cap - used

    def hbm_utilization(self, node_id: str) -> float:
        # ONE snapshot under the lock: reading capacity and the committed
        # sum separately races unregister_node (KeyError mid-failover)
        with self._lock:
            node_cap = self.capacity.get(node_id)
            if node_cap is None:
                return 1.0
            cap = node_cap.hbm_bytes
            used = sum(c.hbm_bytes for c in self.committed[node_id].values())
        return used / cap if cap else 1.0

    def fits(self, node_id: str, hbm_bytes: int, spec=None) -> bool:
        """``spec`` is accepted (and ignored) so the monitor stays
        call-compatible with the quota-aware ``AdmissionController.fits``
        that placement policies normally score against."""
        with self._lock:
            node_cap = self.capacity.get(node_id)
            if node_cap is None:
                return False
            used = sum(c.hbm_bytes for c in self.committed[node_id].values())
            return node_cap.hbm_bytes - used >= hbm_bytes

    def commit(self, node_id: str, key: str, hbm_bytes: int) -> bool:
        """Atomic admission: reserve or refuse (paper: avoid overload)."""
        with self._lock:
            cap = self.capacity.get(node_id)
            if cap is None:
                return False
            used = sum(c.hbm_bytes for c in self.committed[node_id].values())
            if used + hbm_bytes > cap.hbm_bytes:
                return False
            self.committed[node_id][key] = Commitment(hbm_bytes=hbm_bytes)
            return True

    def release(self, node_id: str, key: str):
        with self._lock:
            if node_id in self.committed:
                self.committed[node_id].pop(key, None)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                n: {
                    "hbm_total": float(self.capacity[n].hbm_bytes),
                    "hbm_used": float(sum(
                        c.hbm_bytes for c in self.committed[n].values())),
                    "instances": float(len(self.committed[n])),
                }
                for n in self.capacity
            }
