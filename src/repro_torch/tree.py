"""Parameter-tree helpers in place of ``jax.tree_util``.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
any other objects) as leaves; ``None`` is an empty subtree.  Leaves come
in JAX's order (dict keys sorted) and their paths in JAX's ``keystr``
form (``['params']['w'][0].q``), so checkpoints written by either package
index their leaves the same way.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in flatten_with_path(getattr(tree, f),
                                              f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in flatten_with_path(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, in leaf order, and the matching
    leaves of the trees in ``rest`` (which may be deeper: a NamedTuple
    there is passed whole where ``tree`` has a leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):                  # in leaf order
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, x, *(r[i] for r in rest))
                            for i, x in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, values):
    """A tree shaped like ``tree`` whose leaves are ``values``, taken in
    leaf order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more values than leaves")
    return out


_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|\d+)\]|\.(\w+)")


def parse_path(path: str) -> list:
    """``"['a'][0].q"`` → ``["a", 0, (".", "q")]``: dict keys, list
    indices and NamedTuple fields."""
    out, pos = [], 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            raise ValueError(f"cannot parse tree path {path!r}")
        pos = m.end()
        key, attr = m.groups()
        if attr is not None:
            out.append((".", attr))
        elif key[0] in "'\"":
            out.append(key[1:-1])
        else:
            out.append(int(key))
    if pos != len(path):
        raise ValueError(f"cannot parse tree path {path!r}")
    return out


def unflatten(items, namedtuples: dict) -> Any:
    """Rebuild a tree from ``(path, leaf)`` pairs.  Dict keys become
    dicts, indices lists, and fields the NamedTuple of ``namedtuples``
    whose field names match (``{("q", "scale"): QuantMoment}``)."""
    root: dict = {}
    for path, leaf in items:
        keys = parse_path(path)
        if not keys:
            return leaf
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        ks = list(node)
        if ks and all(isinstance(k, tuple) for k in ks):
            fields = tuple(k[1] for k in ks)
            cls = namedtuples.get(fields)
            if cls is None:
                raise ValueError(f"no NamedTuple with fields {fields}")
            return cls(*(build(node[k]) for k in ks))
        if ks and all(isinstance(k, int) for k in ks):
            return [build(node[i]) for i in sorted(ks)]
        return {k: build(v) for k, v in node.items()}

    return build(root)
