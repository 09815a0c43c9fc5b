"""LO — lock-order rule.

Builds the inter-class lock-acquisition graph: an edge ``A.x → B.y``
means some code path acquires ``B.y`` while holding ``A.x``, either by
direct ``with`` nesting or through a resolved cross-object call whose
transitive lock set (fixpoint over the call graph) contains ``B.y``.

- **LO001** (error): a cycle in the graph — two threads taking the locks
  in opposite orders can deadlock.  Anchored on the sorted cycle nodes.
- **LO002** (error): a non-reentrant ``threading.Lock`` re-acquired on a
  path that already holds it — self-deadlock.  RLocks and condition
  re-entry on the same underlying lock are exempt.
- **LO003** (warning): a lock edge that *crosses top-level packages*
  (e.g. a ``fleet`` router holding its lock into a ``serving`` engine
  probe).  Not a defect by itself, but every such edge widens the
  surface where an independent change in the other package can close a
  cycle — each one must be acknowledged in the baseline with a note
  explaining the ordering contract.  Anchored ``src->dst``; the package
  is the first path segment of the lock-owning class's module, so
  single-directory trees (the test fixtures) never fire it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.findings import Finding, Severity
from repro_torch.analysis.project import Project
from repro_torch.analysis.rules import Rule

Edge = Tuple[str, str]


def build_lock_graph(project: Project):
    """edges: (src, dst) → evidence list of (module, Class.method, line)."""
    trans = project.transitive_locks()
    edges: Dict[Edge, List[Tuple[str, str, int]]] = {}

    def add(src: str, dst: str, module: str, where: str, line: int):
        if src == dst:
            return
        edges.setdefault((src, dst), []).append((module, where, line))

    for cls in project.classes.values():
        for meth in cls.methods.values():
            where = f"{cls.name}.{meth.name}"
            for acq in meth.acquires:
                if acq.lock_id.startswith("?"):
                    continue
                for held in acq.held:
                    if not held.startswith("?"):
                        add(held, acq.lock_id, cls.module, where,
                            acq.line)
            for call in meth.calls:
                if not call.target:
                    continue
                for dst in trans.get(call.target, ()):
                    for held in call.held:
                        if not held.startswith("?"):
                            add(held, dst, cls.module, where, call.line)
    return edges


def _cycles(edges) -> List[List[str]]:
    """Strongly connected components with >1 node (Tarjan, iterative)."""
    graph: Dict[str, Set[str]] = {}
    for (src, dst) in edges:
        graph.setdefault(src, set()).add(dst)
        graph.setdefault(dst, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(graph[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(graph[nxt])))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    scc.append(member)
                    if member == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))
    return sccs


class LockOrder(Rule):
    family = "LO"
    name = "lock-order"
    description = ("inter-class lock-acquisition graph must be acyclic; "
                   "non-reentrant locks must not be re-acquired")

    def run(self, project: Project) -> Iterator[Finding]:
        edges = build_lock_graph(project)
        for scc in _cycles(edges):
            evidence = []
            for (src, dst), ev in sorted(edges.items()):
                if src in scc and dst in scc:
                    m, where, line = ev[0]
                    evidence.append(f"{src}->{dst} at {where} "
                                    f"({m}:{line})")
            anchor = "->".join(scc)
            mod, line = "", 0
            for (src, dst), ev in sorted(edges.items()):
                if src in scc and dst in scc:
                    mod, _, line = ev[0]
                    break
            yield Finding(
                rule="LO001", severity=Severity.ERROR, path=mod,
                line=line, anchor=anchor,
                message=("lock-order cycle (deadlock risk): "
                         + "; ".join(evidence)))

        # LO003: lock edges that cross top-level packages
        def package_of(lock_id: str) -> str:
            cls = project.classes.get(lock_id.split(".", 1)[0])
            if cls is None:
                return ""
            parts = cls.module.split("/")
            return parts[0] if len(parts) > 1 else ""

        for (src, dst), ev in sorted(edges.items()):
            sp, dp = package_of(src), package_of(dst)
            if not sp or not dp or sp == dp:
                continue
            mod, where, line = ev[0]
            yield Finding(
                rule="LO003", severity=Severity.WARNING, path=mod,
                line=line, anchor=f"{src}->{dst}",
                message=(f"cross-package lock edge {src} ({sp}) -> "
                         f"{dst} ({dp}) at {where}; acknowledge the "
                         f"ordering contract in the baseline"))

        # LO002: plain Lock re-acquired while already held
        reentrant = set()
        plain = set()
        for cls in project.classes.values():
            for attr, decl in cls.locks.items():
                lid = cls.lock_id(attr)
                if decl.kind == "rlock":
                    reentrant.add(lid)
                elif decl.kind == "lock":
                    plain.add(lid)
        plain -= reentrant
        trans = project.transitive_locks()
        for cls in project.classes.values():
            for meth in cls.methods.values():
                where = f"{cls.name}.{meth.name}"
                for acq in meth.acquires:
                    if acq.lock_id in plain and acq.lock_id in acq.held:
                        yield Finding(
                            rule="LO002", severity=Severity.ERROR,
                            path=cls.module, line=acq.line,
                            anchor=f"{where}:{acq.lock_id}",
                            message=(f"non-reentrant {acq.lock_id} "
                                     f"re-acquired while already held "
                                     f"in {where} (self-deadlock)"))
                for call in meth.calls:
                    if not call.target:
                        continue
                    for lid in trans.get(call.target, ()):
                        if lid in plain and lid in call.held:
                            yield Finding(
                                rule="LO002", severity=Severity.ERROR,
                                path=cls.module, line=call.line,
                                anchor=f"{where}:{lid}",
                                message=(
                                    f"call to {'.'.join(call.target)} "
                                    f"may re-acquire non-reentrant "
                                    f"{lid} already held in {where} "
                                    f"(self-deadlock)"))
