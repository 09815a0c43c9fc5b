"""KV cache managers: the port of ``repro.serving.kv_cache``'s
``PagedKVCache`` (the paged serving data plane) and ``SlotKVCache`` (the
dense slot plane of the stateful families, and the speculative draft's
cache).

Every layer holds a ``[num_pages, page_size, Hkv, D]`` pool (stacked
``[L, ...]``); each admitted request owns a page-table row mapping its
logical pages to physical ones.  Physical page 0 is the trash page: masked
writes land there, so it is never handed out.  Pages are refcounted so the
prefix-sharing layer can attach one physical page to several requests;
a mid-page divergence is resolved at admission by copying the boundary
page (``cow_src``).

Host state (free lists, ownership, refcounts) is plain Python.  The pools,
the shared ``page_table`` and ``cache_len`` are device tensors updated in
place — where the JAX manager rebinds new arrays and donates the old ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def kv_bytes_per_token(cfg: ModelConfig, dtype=torch.bfloat16) -> int:
    """Per-token KV footprint of an arch, summed over layers and leaves
    (shapes only: the tree lives on the meta device)."""
    return _tree_bytes(transformer.init_paged_cache_tree(cfg, 1, 1, dtype,
                                                         "meta"))


def autotune_page_size(cfg: ModelConfig, dtype=torch.bfloat16,
                       target_page_bytes: int = 256 * 1024) -> int:
    """The power of two in [8, 128] whose page lands nearest
    ``target_page_bytes`` of KV (all layers)."""
    bpt = max(kv_bytes_per_token(cfg, dtype), 1)
    return min((8 << i for i in range(5)),
               key=lambda ps: abs(ps * bpt - target_page_bytes))


class SlotKVCache:
    """Dense slot cache: one cache tree (``transformer.init_cache_tree``)
    whose batch axis holds one sequence per slot: attention KV and, for
    the ssm and hybrid families, the conv and SSM states.  The dense slot
    data plane of the engine claims slots with ``alloc``; the speculative
    draft's slots mirror the engine's paged slots, so it allocates none of
    its own.  A batch-1 cache tree (a prefill's staging cache) is copied
    into a slot by ``insert``; decode advances all slots together."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_seq: int,
                 dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.caches = transformer.init_cache_tree(cfg, max_slots, max_seq,
                                                  dtype, self.device)
        # each leaf's batch axis, from two shape-only trees of 1 and 2
        # slots: the hybrid's leaves hold it at different depths
        one, two = (transformer.init_cache_tree(cfg, n, max_seq, dtype,
                                                "meta") for n in (1, 2))
        self.batch_axes = tree_map(
            lambda a, b: next(i for i, (m, n) in enumerate(zip(a.shape,
                                                               b.shape))
                              if m != n), one, two)
        self.free_slots: List[int] = list(range(max_slots))
        self.cache_len = torch.zeros((max_slots,), dtype=torch.int32,
                                     device=self.device)
        self._capacity_bytes = _tree_bytes(self.caches)

    def alloc(self) -> Optional[int]:
        return self.free_slots.pop(0) if self.free_slots else None

    def free(self, slot: int):
        assert 0 <= slot < self.max_slots
        self.free_slots.append(slot)

    def insert(self, slot_caches, slot: int, length: int):
        """Copy a batch-1 cache tree into ``slot``, cast to the slot tree's
        dtype, and set its length."""
        tree_map(lambda big, small, axis: big.select(axis, slot).copy_(
            small.select(axis, 0)), self.caches, slot_caches,
            self.batch_axes)
        self.cache_len[slot] = length

    def utilization(self) -> float:
        return 1.0 - len(self.free_slots) / self.max_slots

    # ----------------------------------------------------- byte accounting
    def capacity_bytes(self) -> int:
        return self._capacity_bytes

    def bytes_in_use(self) -> int:
        """A claimed slot commits its whole ``max_seq`` row."""
        used = self.max_slots - len(self.free_slots)
        return self._capacity_bytes * used // self.max_slots

    def dense_equivalent_bytes(self) -> int:
        return self._capacity_bytes


class PagedKVCache:
    """Page-pool KV manager for the dense full-attention decoder.

    A request's prefill writes through a standalone table row (handed out
    by ``alloc``) and is installed into the shared ``page_table`` only when
    its prompt is complete, so decode never reads half-written pages and
    unowned rows stay all-zero (the trash page)."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_seq: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.device = resolve_device(device)
        self.pages_per_slot = -(-max_seq // page_size)     # table width MP
        if num_pages is None:
            num_pages = max_slots * self.pages_per_slot + 1
        if num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one max_seq sequence "
                f"({self.pages_per_slot} pages) plus the trash page")
        self.num_pages = num_pages
        self.pools = transformer.init_paged_cache_tree(
            cfg, num_pages, page_size, dtype, self.device)
        self.page_table = torch.zeros((max_slots, self.pages_per_slot),
                                      dtype=torch.int32, device=self.device)
        self.cache_len = torch.zeros((max_slots,), dtype=torch.int32,
                                     device=self.device)
        self.free_slots: List[int] = list(range(max_slots))
        self.free_pages: List[int] = list(range(1, num_pages))  # 0 = trash
        self.slot_pages: Dict[int, List[int]] = {}
        # refcount per allocated page; invariant pages_in_use() == len(refs)
        self.page_refs: Dict[int, int] = {}
        self.slot_shared: Dict[int, int] = {}
        self.cow_copies = 0
        self._capacity_bytes = _tree_bytes(self.pools)
        self._page_bytes = self._capacity_bytes // num_pages

    # ------------------------------------------------------------- queries
    def pages_needed(self, n_tokens: int) -> int:
        return -(-min(n_tokens, self.max_seq) // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        return bool(self.free_slots) and \
            len(self.free_pages) >= self.pages_needed(n_tokens)

    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self.free_pages)

    def utilization(self) -> float:
        return 1.0 - len(self.free_slots) / self.max_slots

    def page_utilization(self) -> float:
        return self.pages_in_use() / max(self.num_pages - 1, 1)

    # ----------------------------------------------------- byte accounting
    def capacity_bytes(self) -> int:
        return self._capacity_bytes

    def bytes_in_use(self) -> int:
        return self.pages_in_use() * self._page_bytes

    def dense_equivalent_bytes(self) -> int:
        return self.max_slots * self.pages_per_slot * self._page_bytes

    # --------------------------------------------------------- refcounting
    def _take_page(self) -> int:
        pid = self.free_pages.pop(0)
        assert pid not in self.page_refs
        self.page_refs[pid] = 1
        return pid

    def ref_page(self, pid: int) -> int:
        assert pid in self.page_refs, f"ref on unallocated page {pid}"
        self.page_refs[pid] += 1
        return self.page_refs[pid]

    def unref_page(self, pid: int) -> bool:
        """Drop one reference; True when the page went back to the free
        list (its last holder let go)."""
        refs = self.page_refs.get(pid)
        assert refs is not None and refs > 0, f"unref of free page {pid}"
        if refs == 1:
            del self.page_refs[pid]
            self.free_pages.append(pid)
            return True
        self.page_refs[pid] = refs - 1
        return False

    # ---------------------------------------------------------- allocation
    def alloc(self, n_tokens: int, shared_pages=(), cow_src=None):
        """Reserve a slot and pages for ``n_tokens``.  ``shared_pages``
        attach a resident prefix by reference (never written by this
        request); ``cow_src`` copy-seeds the first private page.  Returns
        ``(slot, table_row [1, MP] int32 tensor)`` or ``None`` when slots
        or private pages run out (nothing is reserved then)."""
        need = self.pages_needed(n_tokens)
        shared = list(shared_pages)
        assert len(shared) < need or (len(shared) == need and need == 0), \
            "shared prefix must leave at least one private page"
        priv_need = need - len(shared)
        if not self.free_slots or len(self.free_pages) < priv_need:
            return None
        slot = self.free_slots.pop(0)
        for pid in shared:
            self.ref_page(pid)
        priv = [self._take_page() for _ in range(priv_need)]
        if cow_src is not None and priv:
            self.copy_page(cow_src, priv[0])
            self.cow_copies += 1
        pages = shared + priv
        self.slot_pages[slot] = pages
        self.slot_shared[slot] = len(shared)
        row = np.zeros((1, self.pages_per_slot), np.int32)
        row[0, :need] = pages
        return slot, torch.from_numpy(row).to(self.device)

    def copy_page(self, src: int, dst: int):
        """Copy one physical page across every layer pool, in place."""
        for leaf in self.pools["attn"].values():
            leaf[:, dst] = leaf[:, src]

    def append_page(self, slot: int) -> Optional[int]:
        """Grow an installed slot by one private page and publish it in
        the shared table (the row's valid length still points below it).
        ``None`` when the pool is dry or the slot is at ``max_seq`` width."""
        pages = self.slot_pages.get(slot)
        assert pages is not None, f"append_page on unallocated slot {slot}"
        if len(pages) >= self.pages_per_slot or not self.free_pages:
            return None
        pid = self._take_page()
        self.page_table[slot, len(pages)] = pid
        pages.append(pid)
        return pid

    def install(self, slot: int, table_row, length: int):
        """Publish a finished prefill: the slot's row becomes visible to
        the decode batch and its valid length is set."""
        self.page_table[slot] = table_row[0]
        self.cache_len[slot] = length

    def free(self, slot: int):
        """Drop the slot's page references and zero its table row, so a
        stale masked decode write for this row lands on the trash page."""
        assert 0 <= slot < self.max_slots
        for pid in self.slot_pages.pop(slot, []):
            self.unref_page(pid)
        self.slot_shared.pop(slot, None)
        self.page_table[slot] = 0
        self.cache_len[slot] = 0
        self.free_slots.append(slot)
