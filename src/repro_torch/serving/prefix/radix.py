"""Radix prefix index: chained block fingerprints → refcounted KV pages.

A numpy-only copy of ``repro.serving.prefix.radix``; the logic is
unchanged, so the port's engine shares and evicts exactly as the JAX one.

The sharing unit is one physical page of the ``PagedKVCache`` (one
``page_size``-token block).  Keys reuse the **chained** blake2b block
fingerprints from ``fleet.affinity.prefix_fingerprints`` — the same
digests the fleet router's affinity index is built on — so a prompt's
fingerprint list is a prefix of every extension's list and the router's
affinity hit and the engine's physical page hit agree on what "the same
prefix" means.

Two node shapes hang off the tree:

* **complete nodes** — one per complete token block, keyed by the
  chained fingerprint, owning one fully-valid physical page.  Chaining
  makes the walk longest-prefix: the first unknown fingerprint ends it.
* **tail nodes** — a partial trailing block (``valid < page_size``
  tokens).  Tails store their raw tokens and match by token comparison
  (a partial block has no stable fingerprint), so the divergence
  boundary can land mid-page — the copy-then-append COW case.

Every node holds exactly one reference on its page
(``cache.ref_page``/``unref_page``); requests that attach a matched
prefix hold their own reference, so LRU eviction of a node can never
free a page out from under an in-flight reader.  ``pin``/``unpin``
additionally protect the *index entries* of in-flight matches: eviction
only considers unpinned childless leaves, and interior nodes are
protected structurally (they have children).

Concurrency: the index is **not** thread-safe on its own — the owning
``ServingEngine`` guards every mutating call with the engine lock.
``match(..., touch=False)`` mutates nothing, for lock-free probes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set

import numpy as np

from repro_torch.fleet.affinity import prefix_fingerprints


class PrefixNode:
    """One shared block: a physical page plus its position in the tree.

    ``tokens is None`` ⇔ complete node (keyed by ``fp`` in the parent's
    ``children``); tail nodes carry their raw tokens and live in the
    parent's ``tails`` list.
    """

    __slots__ = ("fp", "page", "valid", "tokens", "parent", "children",
                 "tails", "pins", "last_use")

    def __init__(self, fp: Optional[str], page: int, valid: int,
                 parent: Optional["PrefixNode"],
                 tokens: Optional[np.ndarray] = None):
        self.fp = fp
        self.page = page
        self.valid = valid
        self.tokens = tokens
        self.parent = parent
        self.children: Dict[str, "PrefixNode"] = {}
        self.tails: List["PrefixNode"] = []
        self.pins = 0
        self.last_use = 0

    def is_leaf(self) -> bool:
        return not self.children and not self.tails


@dataclasses.dataclass
class MatchResult:
    """Longest-prefix match: the complete-node chain (root-first), an
    optional tail whose first ``matched_tokens - page_size*len(nodes)``
    tokens continue the prompt, and the total matched token count."""
    nodes: List[PrefixNode]
    tail: Optional[PrefixNode]
    matched_tokens: int


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    if n == 0:
        return 0
    eq = a[:n] == b[:n]
    return int(n if eq.all() else np.argmin(eq))


class PrefixRadixIndex:
    """Radix/trie over chained block fingerprints → refcounted pages."""

    def __init__(self, page_size: int, max_tails: int = 4):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self.max_tails = max_tails
        self.root = PrefixNode(None, -1, 0, None)
        self._nodes: Set[PrefixNode] = set()
        self._clock = 0
        self.hits = 0
        self.partial_hits = 0
        self.misses = 0
        self.inserted = 0
        self.evicted = 0

    # ------------------------------------------------------------- queries
    @property
    def pages(self) -> int:
        """Physical pages held by the index (each node owns one ref)."""
        return len(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    # ------------------------------------------------------------ matching
    def match(self, tokens, *, touch: bool = True) -> MatchResult:
        """Longest shared prefix of ``tokens``: walk complete nodes by
        chained fingerprint, then extend into the best-matching tail.
        ``touch=False`` skips the LRU/counter updates (lock-free probing
        from the router scoring path must not mutate the index)."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        nodes: List[PrefixNode] = []
        node = self.root
        for fp in prefix_fingerprints(toks, block=self.page_size):
            child = node.children.get(fp)
            if child is None:
                break
            nodes.append(child)
            node = child
        matched = len(nodes) * self.page_size
        tail, best = None, 0
        rem = toks[matched:]
        if rem.size:
            for t in node.tails:
                c = _common_prefix(t.tokens[:t.valid], rem)
                if c > best:
                    best, tail = c, t
        if touch:
            self._clock += 1
            for nd in nodes:
                nd.last_use = self._clock
            if tail is not None:
                tail.last_use = self._clock
            if matched + best:
                self.hits += 1
                if best:
                    self.partial_hits += 1
            else:
                self.misses += 1
        return MatchResult(nodes, tail, matched + best)

    # ----------------------------------------------------------- insertion
    def insert(self, tokens, pages: List[int], cache) -> int:
        """Donate a finished request's pages: walk/create the complete
        chain for ``tokens``, then a tail node for the partial block.
        Only NEW nodes take a reference on their page (``cache.ref_page``)
        — existing nodes keep the page they already own (same chained
        fingerprint ⇒ same token prefix ⇒ identical KV bytes, since the
        cache is a deterministic function of the token prefix).  Returns
        the number of nodes created."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        fps = prefix_fingerprints(toks, block=self.page_size)
        usable = min(len(fps), len(pages))
        self._clock += 1
        node, created = self.root, 0
        for i in range(usable):
            child = node.children.get(fps[i])
            if child is None:
                child = PrefixNode(fps[i], pages[i], self.page_size, node)
                cache.ref_page(pages[i])
                node.children[fps[i]] = child
                self._nodes.add(child)
                created += 1
            child.last_use = self._clock
            node = child
        rem = toks[usable * self.page_size:]
        if 0 < rem.size < self.page_size and len(pages) > usable:
            covered = any(
                t.valid >= rem.size and
                np.array_equal(t.tokens[:rem.size], rem)
                for t in node.tails)
            if not covered:
                t = PrefixNode(None, pages[usable], int(rem.size), node,
                               tokens=rem.copy())
                cache.ref_page(pages[usable])
                t.last_use = self._clock
                node.tails.append(t)
                self._nodes.add(t)
                created += 1
                while len(node.tails) > self.max_tails:
                    lru = [x for x in node.tails if x.pins == 0]
                    if not lru:
                        break
                    self._remove(min(lru, key=lambda x: x.last_use), cache)
        self.inserted += created
        return created

    # ----------------------------------------------------------- pin/unpin
    def pin(self, nodes: Iterable[PrefixNode]) -> None:
        for nd in nodes:
            nd.pins += 1

    def unpin(self, nodes: Iterable[PrefixNode]) -> None:
        for nd in nodes:
            nd.pins -= 1
            assert nd.pins >= 0, "unpin without matching pin"

    # ------------------------------------------------------------ eviction
    def _remove(self, node: PrefixNode, cache) -> bool:
        """Detach a leaf and drop its page reference; True if the page
        actually returned to the free list (no request still holds it)."""
        assert node.is_leaf() and node.pins == 0
        parent = node.parent
        if node.tokens is None:
            parent.children.pop(node.fp, None)
        else:
            parent.tails.remove(node)
        self._nodes.discard(node)
        self.evicted += 1
        return bool(cache.unref_page(node.page))

    def evict(self, cache, need_pages: int = 1) -> int:
        """LRU eviction of unpinned childless leaves until ``need_pages``
        pages returned to the free list (or no candidates remain).
        Pinned nodes are never touched; interior nodes become candidates
        only once their subtree is gone."""
        freed = 0
        while freed < need_pages:
            cands = [n for n in self._nodes
                     if n.pins == 0 and n.is_leaf()]
            if not cands:
                break
            if self._remove(min(cands, key=lambda n: n.last_use), cache):
                freed += 1
        return freed

    def clear(self, cache) -> int:
        """Drop every unpinned node (tests / explicit cache release).
        Returns pages actually freed."""
        freed, progressed = 0, True
        while progressed:
            progressed = False
            for n in [n for n in self._nodes
                      if n.pins == 0 and n.is_leaf()]:
                freed += int(self._remove(n, cache))
                progressed = True
        return freed

    # ----------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, int]:
        return {"nodes": len(self._nodes), "pages": self.pages,
                "hits": self.hits, "partial_hits": self.partial_hits,
                "misses": self.misses, "inserted": self.inserted,
                "evicted": self.evicted}
