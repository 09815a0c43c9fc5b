"""Shared AST model the rules run against.

Parses every ``*.py`` under the analysis root and extracts, per class:

- **lock declarations** — ``self._x = threading.Lock()/RLock()``, plus
  ``threading.Condition(self._y)`` recorded as an *alias* of its
  underlying lock (acquiring/waiting the condition acquires the lock);
- **attribute types** — best-effort inference from ``self.a = Cls(...)``,
  annotated ``__init__`` parameters (including string and ``Optional``
  annotations), the ``self.a = param or Cls(...)`` idiom, and one-hop
  ``self.a = param.b`` chains;
- **per-method events with the held-lock set at each point** — self-field
  reads/writes, attribute-call sites (resolved to ``Class.method`` where
  the receiver type is known, including receivers reached through typed
  *local variables*: annotated parameters, assignments from known
  factories / typed attribute chains / container subscripts, and loop
  targets over typed containers), and lock acquisitions (``with
  self._x``, ``with self.mgr._route_lock``, plus explicit timed
  ``self._x.acquire(...)`` calls recorded as ordering events);
- **pragmas** — ``# analysis: <directive>`` suppression/metadata comments
  indexed by line.

Lock identity is ``ClassName.attr``.  ``with`` targets that cannot be
resolved to a known class lock but *look* like locks (terminal name
contains "lock") still open a held region (id prefixed ``?``) so the
blocking-while-locked rule sees them, but they never become lock-graph
nodes.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Pragma

PRAGMA_RE = re.compile(r"#\s*analysis:\s*([A-Za-z0-9_.=,\- ]+)")

LOCK_FACTORIES = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

#: method names that mutate their receiver in place — a call
#: ``self.a.append(...)`` counts as a *write* to field ``a``.  Queue
#: ``put``/``get`` are deliberately absent: stdlib queues synchronize
#: internally.
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
})


# --------------------------------------------------------------------------
# extracted facts
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LockDecl:
    attr: str
    kind: str                      # "lock" | "rlock" | "condition"
    cond_of: Optional[str] = None  # underlying lock attr for conditions


@dataclasses.dataclass(frozen=True)
class FieldAccess:
    attr: str
    kind: str                      # "read" | "write"
    line: int
    held: Tuple[str, ...]          # lock ids held at this point


@dataclasses.dataclass(frozen=True)
class CallSite:
    chain: Tuple[str, ...]         # e.g. ("self", "admission", "release")
    target: Optional[Tuple[str, str]]   # resolved (class, method) or None
    line: int
    held: Tuple[str, ...]
    node: ast.Call = dataclasses.field(repr=False, compare=False,
                                       default=None)


@dataclasses.dataclass(frozen=True)
class AcquireSite:
    lock_id: str                   # "Cls.attr" or "?name" for unknowns
    line: int
    held: Tuple[str, ...]          # locks already held when acquiring


@dataclasses.dataclass
class MethodInfo:
    cls_name: str
    name: str
    node: ast.FunctionDef
    accesses: List[FieldAccess] = dataclasses.field(default_factory=list)
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    acquires: List[AcquireSite] = dataclasses.field(default_factory=list)

    @property
    def def_line(self) -> int:
        return self.node.lineno


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str                    # root-relative posix path
    node: ast.ClassDef
    locks: Dict[str, LockDecl] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: container attr → element class (``Dict[k, V]`` → V, ``List[X]`` → X)
    elem_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, MethodInfo] = dataclasses.field(default_factory=dict)

    def lock_id(self, attr: str) -> Optional[str]:
        """Canonical lock id for one of this class's lock attrs, following
        condition → underlying-lock aliasing."""
        decl = self.locks.get(attr)
        if decl is None:
            return None
        if decl.kind == "condition" and decl.cond_of in self.locks:
            return f"{self.name}.{decl.cond_of}"
        return f"{self.name}.{attr}"

    @property
    def own_lock_ids(self) -> frozenset:
        return frozenset(f"{self.name}.{a}" for a, d in self.locks.items()
                         if d.kind != "condition")


@dataclasses.dataclass
class ModuleInfo:
    relpath: str
    path: Path
    tree: ast.Module
    lines: List[str]
    pragmas: Dict[int, List[Pragma]] = dataclasses.field(
        default_factory=dict)

    def pragma_at(self, line: int, key: str) -> Optional[Pragma]:
        for p in self.pragmas.get(line, ()):
            if p.key == key:
                return p
        return None


# --------------------------------------------------------------------------
# small AST helpers
# --------------------------------------------------------------------------

def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``self.admission.release`` → ["self", "admission", "release"];
    None when the chain bottoms out in anything but a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def annotation_class(node: Optional[ast.AST]) -> Optional[str]:
    """Best-effort class name from an annotation node, unwrapping
    ``Optional[X]``, ``Union[X, None]``, string annotations and dots."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
        return annotation_class(node)
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        base = annotation_class(node.value)
        if base in ("Optional", "Union"):
            inner = node.slice
            if isinstance(inner, ast.Tuple) and inner.elts:
                inner = inner.elts[0]
            return annotation_class(inner)
    return None


_MAP_BASES = frozenset({"Dict", "dict", "OrderedDict", "DefaultDict",
                        "Mapping", "MutableMapping"})
_SEQ_BASES = frozenset({"List", "list", "Set", "set", "FrozenSet",
                        "frozenset", "Deque", "deque", "Sequence",
                        "Iterable"})


def container_elem(node: Optional[ast.AST]) -> Optional[str]:
    """Element class of a container annotation: ``Dict[k, V]`` → V (the
    type of ``d[k]`` / ``d.values()`` elements), ``List[X]``/``Set[X]``/
    ``Deque[X]`` → X, unwrapping ``Optional``/string annotations."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if not isinstance(node, ast.Subscript):
        return None
    base = annotation_class(node.value)
    inner = node.slice
    if base in _MAP_BASES:
        if isinstance(inner, ast.Tuple) and len(inner.elts) == 2:
            return annotation_class(inner.elts[1])
        return None
    if base in _SEQ_BASES:
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        return annotation_class(inner)
    if base in ("Optional", "Union"):
        if isinstance(inner, ast.Tuple) and inner.elts:
            inner = inner.elts[0]
        return container_elem(inner)
    return None


def _call_factory(node: ast.AST) -> Optional[str]:
    """Class name when ``node`` is ``X(...)`` / ``mod.X(...)``."""
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if chain:
            return chain[-1]
    return None


# --------------------------------------------------------------------------
# per-method walker
# --------------------------------------------------------------------------

class _MethodWalker:
    """Walks one method body tracking the held-lock set; ``with`` bodies
    extend it, nested function/lambda bodies reset it (they run later,
    in an unknown lock context).

    Also tracks best-effort **local variable types** in statement order —
    seeded from annotated parameters, updated by assignments from known
    factories / typed attribute chains / container subscripts and by
    ``for``-loops over ``.values()`` — so locks and calls reached through
    temporaries (``eng = dep.executor.engine; eng.submit()``) resolve to
    real classes instead of falling out of the lock graph."""

    def __init__(self, project: "Project", cls: ClassInfo,
                 method: MethodInfo):
        self.project = project
        self.cls = cls
        self.method = method
        args = method.node.args
        self.var_types: Dict[str, str] = {}
        #: local → element class of the container it holds (so loops over
        #: ``live = self._live()`` type their targets)
        self.var_elem_types: Dict[str, str] = {}
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            t = annotation_class(a.annotation)
            if t:
                self.var_types[a.arg] = t
            elem = container_elem(a.annotation)
            if elem:
                self.var_elem_types[a.arg] = elem

    # -- lock / call resolution --------------------------------------------

    def _owner_class(self, chain: Sequence[str]) -> Optional[ClassInfo]:
        """Class owning ``chain[-1]``: type the root (``self`` or a typed
        local), then walk the intermediate hops through ``attr_types``."""
        if chain[0] == "self":
            cls: Optional[ClassInfo] = self.cls
        else:
            cls = self.project.classes.get(
                self.var_types.get(chain[0], ""))
        for hop in chain[1:-1]:
            if cls is None:
                return None
            cls = self.project.classes.get(cls.attr_types.get(hop, ""))
        return cls

    def _chain_lock_id(self, chain: Sequence[str]) -> Optional[str]:
        if len(chain) >= 2:
            owner = self._owner_class(chain)
            if owner is not None:
                return owner.lock_id(chain[-1])
        return None

    def resolve_lock(self, expr: ast.AST) -> Optional[str]:
        chain = attr_chain(expr)
        if not chain:
            return None
        lid = self._chain_lock_id(chain)
        if lid:
            return lid
        if "lock" in chain[-1].lower():
            return f"?{chain[-1]}"
        return None

    def resolve_call(self, chain: Sequence[str]) \
            -> Optional[Tuple[str, str]]:
        if len(chain) < 2:
            return None
        cls = self._owner_class(chain)
        if cls is not None and chain[-1] in cls.methods:
            return (cls.name, chain[-1])
        return None

    # -- local type propagation --------------------------------------------

    def _return_annotation(self, value: ast.AST) -> Optional[ast.AST]:
        """Return-annotation node of a resolved method call, or None."""
        if not isinstance(value, ast.Call):
            return None
        chain = attr_chain(value.func)
        if not chain or len(chain) < 2:
            return None
        target = self.resolve_call(chain)
        if target is None:
            return None
        return self.project.classes[target[0]].methods[target[1]] \
            .node.returns

    def _local_type(self, value: Optional[ast.AST]) -> Optional[str]:
        """Best-effort class name for the RHS of a local assignment."""
        if value is None:
            return None
        factory = _call_factory(value)
        if factory and factory not in LOCK_FACTORIES and \
                factory in self.project.classes:
            return factory
        ret = self._return_annotation(value)
        if ret is not None:
            return annotation_class(ret)
        if isinstance(value, ast.Name):
            return self.var_types.get(value.id)
        chain = attr_chain(value)
        if chain and len(chain) >= 2:
            owner = self._owner_class(chain)
            if owner is not None:
                return owner.attr_types.get(chain[-1])
        if isinstance(value, ast.Subscript):
            # d[k] where d is a typed container → element class
            base = attr_chain(value.value)
            if base and len(base) >= 2:
                owner = self._owner_class(base)
                if owner is not None:
                    return owner.elem_types.get(base[-1])
            elif base and len(base) == 1:
                return self.var_elem_types.get(base[0])
        return None

    def _local_elem_type(self, value: Optional[ast.AST]) -> Optional[str]:
        """Element class of a container-valued RHS (``x = self._live()``
        with ``-> List[ReplicaRef]`` types later loops over ``x``)."""
        if value is None:
            return None
        if isinstance(value, ast.Name):
            return self.var_elem_types.get(value.id)
        ret = self._return_annotation(value)
        if ret is not None:
            return container_elem(ret)
        if isinstance(value, ast.Call) and value.args and \
                isinstance(value.func, ast.Name) and \
                value.func.id in ("sorted", "list", "tuple", "reversed"):
            return self._iter_elem_type(value.args[0])
        return self._iter_elem_type(value)

    def _iter_elem_type(self, it: ast.AST) -> Optional[str]:
        """Element class of an iterable expression: a typed local
        container, ``x.values()`` over a typed mapping, a resolved call
        with a container return annotation, or a ``sorted``/``list``
        wrapper of any of those."""
        if isinstance(it, ast.Name):
            return self.var_elem_types.get(it.id)
        if isinstance(it, ast.Call):
            if isinstance(it.func, ast.Name) and it.args and \
                    it.func.id in ("sorted", "list", "tuple", "reversed"):
                return self._iter_elem_type(it.args[0])
            chain = attr_chain(it.func)
            if chain and len(chain) >= 3 and chain[-1] == "values" and \
                    not it.args:
                owner = self._owner_class(chain[:-1])
                if owner is not None:
                    return owner.elem_types.get(chain[-2])
            ret = self._return_annotation(it)
            if ret is not None:
                return container_elem(ret)
        return None

    def _bind(self, name: str, t: Optional[str],
              elem: Optional[str] = None) -> None:
        if t:
            self.var_types[name] = t
        else:
            # rebound to something unknown: forget the stale type
            self.var_types.pop(name, None)
        if elem:
            self.var_elem_types[name] = elem
        else:
            self.var_elem_types.pop(name, None)

    # -- walking -----------------------------------------------------------

    def walk(self) -> None:
        for stmt in self.method.node.body:
            self._stmt(stmt, ())

    def _stmt(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, ast.With):
            acquired = list(held)
            for item in node.items:
                self._expr(item.context_expr, tuple(acquired))
                lid = self.resolve_lock(item.context_expr)
                if lid is not None:
                    self.method.acquires.append(AcquireSite(
                        lock_id=lid, line=item.context_expr.lineno,
                        held=tuple(acquired)))
                    if lid not in acquired:
                        acquired.append(lid)
            inner = tuple(acquired)
            for child in node.body:
                self._stmt(child, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs execute later, in an unknown lock context
            for child in node.body:
                self._stmt(child, ())
            return
        if isinstance(node, ast.Assign):
            self._expr(node.value, held)
            for tgt in node.targets:
                self._expr(tgt, held)
                if isinstance(tgt, ast.Name):
                    self._bind(tgt.id, self._local_type(node.value),
                               self._local_elem_type(node.value))
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._expr(node.value, held)
            self._expr(node.target, held)
            if isinstance(node.target, ast.Name):
                self._bind(node.target.id,
                           annotation_class(node.annotation) or
                           self._local_type(node.value),
                           container_elem(node.annotation) or
                           self._local_elem_type(node.value))
            return
        if isinstance(node, ast.For):
            self._expr(node.iter, held)
            self._expr(node.target, held)
            if isinstance(node.target, ast.Name):
                self._bind(node.target.id, self._iter_elem_type(node.iter))
            for child in node.body + node.orelse:
                self._stmt(child, held)
            return
        # expressions embedded in this statement (not in nested blocks)
        for _, value in ast.iter_fields(node):
            for sub in ([value] if isinstance(value, ast.AST) else
                        value if isinstance(value, list) else ()):
                if isinstance(sub, ast.stmt):
                    self._stmt(sub, held)
                elif isinstance(sub, ast.expr):
                    self._expr(sub, held)
                elif isinstance(sub, ast.AST):
                    self._stmt(sub, held)

    def _expr(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        # mutation recognizers: ``self.a[k] = v`` / ``del self.a[k]`` and
        # ``self.a.append(...)``-style container mutators are writes to
        # ``a``, not mere reads
        as_write = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Subscript) and isinstance(
                    sub.ctx, (ast.Store, ast.Del)):
                tgt = sub.value
                if isinstance(tgt, ast.Attribute) and isinstance(
                        tgt.value, ast.Name) and tgt.value.id == "self":
                    as_write.add(id(tgt))
            elif isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) and \
                    sub.func.attr in MUTATOR_METHODS:
                tgt = sub.func.value
                if isinstance(tgt, ast.Attribute) and isinstance(
                        tgt.value, ast.Name) and tgt.value.id == "self":
                    as_write.add(id(tgt))
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and \
                    isinstance(sub.value, ast.Name) and \
                    sub.value.id == "self":
                kind = "write" if (id(sub) in as_write or isinstance(
                    sub.ctx, (ast.Store, ast.Del))) else "read"
                self.method.accesses.append(FieldAccess(
                    attr=sub.attr, kind=kind, line=sub.lineno, held=held))
            elif isinstance(sub, ast.Call):
                chain = attr_chain(sub.func)
                if chain and len(chain) >= 2:
                    self.method.calls.append(CallSite(
                        chain=tuple(chain),
                        target=self.resolve_call(chain),
                        line=sub.lineno, held=held, node=sub))
                    if chain[-1] == "acquire" and len(chain) >= 3:
                        # explicit (often timed) lock.acquire(): recorded
                        # as an acquisition *event* for ordering edges;
                        # it does not open a held region
                        lid = self._chain_lock_id(chain[:-1])
                        if lid is not None:
                            self.method.acquires.append(AcquireSite(
                                lock_id=lid, line=sub.lineno, held=held))


# --------------------------------------------------------------------------
# project
# --------------------------------------------------------------------------

class Project:
    """Parsed modules plus the cross-module class index."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.modules: Dict[str, ModuleInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self._load()
        self._index_classes()
        self._infer_attr_types()
        self._walk_methods()

    # -- loading -----------------------------------------------------------

    def _load(self) -> None:
        for path in sorted(self.root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(self.root).as_posix()
            text = path.read_text()
            try:
                tree = ast.parse(text, filename=str(path))
            except SyntaxError:
                continue
            lines = text.splitlines()
            pragmas: Dict[int, List[Pragma]] = {}
            for i, line in enumerate(lines, start=1):
                m = PRAGMA_RE.search(line)
                if m:
                    for d in m.group(1).split(","):
                        d = d.strip()
                        if d:
                            pragmas.setdefault(i, []).append(
                                Pragma(directive=d, line=i))
            self.modules[rel] = ModuleInfo(
                relpath=rel, path=path, tree=tree, lines=lines,
                pragmas=pragmas)

    # -- class index -------------------------------------------------------

    def _index_classes(self) -> None:
        for rel, mod in self.modules.items():
            for node in mod.tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                info = ClassInfo(name=node.name, module=rel, node=node)
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        info.methods[item.name] = MethodInfo(
                            cls_name=node.name, name=item.name, node=item)
                self._find_locks(info)
                # last definition wins on (unlikely) duplicate class names
                self.classes[node.name] = info

    def _find_locks(self, info: ClassInfo) -> None:
        for meth in info.methods.values():
            for stmt in ast.walk(meth.node):
                if not isinstance(stmt, ast.Assign):
                    continue
                for tgt in stmt.targets:
                    chain = attr_chain(tgt)
                    if not chain or chain[0] != "self" or len(chain) != 2:
                        continue
                    factory = _call_factory(stmt.value)
                    if factory not in LOCK_FACTORIES:
                        continue
                    kind = LOCK_FACTORIES[factory]
                    cond_of = None
                    if kind == "condition" and isinstance(
                            stmt.value, ast.Call) and stmt.value.args:
                        arg_chain = attr_chain(stmt.value.args[0])
                        if arg_chain and arg_chain[0] == "self" and \
                                len(arg_chain) == 2:
                            cond_of = arg_chain[1]
                    info.locks[chain[1]] = LockDecl(
                        attr=chain[1], kind=kind, cond_of=cond_of)

    # -- attribute type inference -----------------------------------------

    def _infer_attr_types(self) -> None:
        deferred: List[Tuple[ClassInfo, str, str, str]] = []
        for info in self.classes.values():
            for meth in info.methods.values():
                params = {a.arg: annotation_class(a.annotation)
                          for a in meth.node.args.args +
                          meth.node.args.kwonlyargs}
                for stmt in ast.walk(meth.node):
                    if isinstance(stmt, ast.AnnAssign):
                        chain = attr_chain(stmt.target)
                        if not chain or chain[0] != "self" or \
                                len(chain) != 2:
                            continue
                        attr = chain[1]
                        ann_t = annotation_class(stmt.annotation)
                        if ann_t:
                            info.attr_types.setdefault(attr, ann_t)
                        elem = container_elem(stmt.annotation)
                        if elem:
                            info.elem_types.setdefault(attr, elem)
                        continue
                    if not isinstance(stmt, ast.Assign):
                        continue
                    for tgt in stmt.targets:
                        chain = attr_chain(tgt)
                        if not chain or chain[0] != "self" or \
                                len(chain) != 2:
                            continue
                        attr = chain[1]
                        t = self._value_type(stmt.value, params)
                        if isinstance(t, str):
                            info.attr_types.setdefault(attr, t)
                        elif isinstance(t, tuple):
                            deferred.append((info, attr) + t)
        # one-hop chains: self.a = param.b where param's class is known
        for info, attr, base_cls, hop in deferred:
            base = self.classes.get(base_cls)
            if base is not None:
                t = base.attr_types.get(hop)
                if t:
                    info.attr_types.setdefault(attr, t)

    def _value_type(self, value: ast.AST, params: Dict[str, Optional[str]]):
        """str → class name; (cls, attr) → deferred one-hop; None."""
        factory = _call_factory(value)
        if factory and factory not in LOCK_FACTORIES:
            # X(...) — only meaningful if X names a class we know;
            # unknown names simply never resolve at lookup time
            return factory
        if isinstance(value, ast.Name):
            return params.get(value.id)
        if isinstance(value, ast.BoolOp) and isinstance(value.op, ast.Or):
            for opt in value.values:
                t = self._value_type(opt, params)
                if t:
                    return t
        if isinstance(value, ast.Attribute) and \
                isinstance(value.value, ast.Name):
            base = params.get(value.value.id)
            if base:
                return (base, value.attr)
        if isinstance(value, ast.IfExp):
            for opt in (value.body, value.orelse):
                t = self._value_type(opt, params)
                if t:
                    return t
        return None

    # -- method walking ----------------------------------------------------

    def _walk_methods(self) -> None:
        for info in self.classes.values():
            for meth in info.methods.values():
                _MethodWalker(self, info, meth).walk()

    # -- shared queries ----------------------------------------------------

    def intra_class_call_sites(self, cls: ClassInfo) \
            -> Dict[str, List[Tuple[MethodInfo, CallSite]]]:
        """method name → call sites targeting it from within the class."""
        sites: Dict[str, List[Tuple[MethodInfo, CallSite]]] = {}
        for meth in cls.methods.values():
            for call in meth.calls:
                if call.target == (cls.name, call.chain[-1]) and \
                        call.chain[0] == "self" and len(call.chain) == 2:
                    sites.setdefault(call.chain[-1], []).append(
                        (meth, call))
        return sites

    def transitive_locks(self) -> Dict[Tuple[str, str], frozenset]:
        """Fixpoint: (class, method) → every known lock id the call may
        acquire, directly or through resolved callees."""
        locks: Dict[Tuple[str, str], set] = {}
        for info in self.classes.values():
            for meth in info.methods.values():
                direct = {a.lock_id for a in meth.acquires
                          if not a.lock_id.startswith("?")}
                locks[(info.name, meth.name)] = direct
        changed = True
        while changed:
            changed = False
            for info in self.classes.values():
                for meth in info.methods.values():
                    key = (info.name, meth.name)
                    cur = locks[key]
                    for call in meth.calls:
                        if call.target and call.target in locks:
                            extra = locks[call.target] - cur
                            if extra:
                                cur |= extra
                                changed = True
        return {k: frozenset(v) for k, v in locks.items()}

    def effectively_locked(self, cls: ClassInfo) -> frozenset:
        """Methods that are lock-held-on-entry: ``*_locked`` names, plus
        the fixpoint over private methods whose every intra-class call
        site runs under one of the class's own locks (directly or from
        an effectively-locked caller)."""
        own = cls.own_lock_ids
        sites = self.intra_class_call_sites(cls)
        locked = {m for m in cls.methods if m.endswith("_locked")}
        changed = True
        while changed:
            changed = False
            for name, meth in cls.methods.items():
                if name in locked or not name.startswith("_") or \
                        name.startswith("__"):
                    continue
                call_sites = sites.get(name)
                if not call_sites:
                    continue
                if all(set(c.held) & own or caller.name in locked
                       for caller, c in call_sites):
                    locked.add(name)
                    changed = True
        return frozenset(locked)
