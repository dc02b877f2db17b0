"""Payload trees: tuples, lists and dicts whose leaves are tensors.

The scan collectives take structured payloads (the (a, b) pair of the
affine monoid, a dict of per-leaf counts, ...).  These helpers flatten,
rebuild and map over such trees, in the leaf order ``jax.tree`` uses:
tuples and lists in position order, named tuples (``AdamWState``) by
field, dicts by sorted key, and ``None`` as an empty node.
:func:`paths` names the leaves as ``jax.tree_util.keystr`` does
(``['opt'].mu['blocks'][0]['wk']``), which is what checkpoints record.
"""

from __future__ import annotations

from typing import Any, Callable

_LEAF = "*"


class TreeDef:
    """The structure of a payload tree without its leaves (hashable,
    comparable: two payloads with equal treedefs fuse and combine)."""

    __slots__ = ("_spec",)

    def __init__(self, spec):
        self._spec = spec

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self._spec == other._spec

    def __hash__(self):
        return hash(self._spec)

    def __repr__(self):
        return f"TreeDef({self._spec!r})"

    @property
    def num_leaves(self) -> int:
        return _count(self._spec)


def _count(spec) -> int:
    if spec == _LEAF:
        return 1
    if spec is None:
        return 0
    return sum(_count(c) for c in spec[-1])


def _flatten(tree, out: list):
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return ("namedtuple", type(tree),
                tuple(_flatten(c, out) for c in tree))
    if isinstance(tree, tuple):
        return ("tuple", tuple(_flatten(c, out) for c in tree))
    if isinstance(tree, list):
        return ("list", tuple(_flatten(c, out) for c in tree))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], out) for k in keys))
    out.append(tree)
    return _LEAF


def flatten(tree) -> tuple[list, TreeDef]:
    """Leaves of ``tree`` in canonical order, and its structure."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    return leaves, TreeDef(spec)


def _build(spec, it):
    if spec == _LEAF:
        return next(it)
    if spec is None:
        return None
    if spec[0] == "namedtuple":
        return spec[1](*(_build(c, it) for c in spec[2]))
    if spec[0] == "tuple":
        return tuple(_build(c, it) for c in spec[1])
    if spec[0] == "list":
        return [_build(c, it) for c in spec[1]]
    return {k: _build(c, it) for k, c in zip(spec[1], spec[2])}


def unflatten(treedef: TreeDef, leaves) -> Any:
    """Rebuild a tree of ``treedef``'s structure from ``leaves``."""
    it = iter(leaves)
    out = _build(treedef._spec, it)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over for {treedef}")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _paths(tree, prefix: str, out: list) -> None:
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name, c in zip(type(tree)._fields, tree):
            _paths(c, f"{prefix}.{name}", out)
    elif isinstance(tree, (tuple, list)):
        for i, c in enumerate(tree):
            _paths(c, f"{prefix}[{i}]", out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _paths(tree[k], f"{prefix}[{k!r}]", out)
    else:
        out.append(prefix)


def paths(tree) -> list[str]:
    """Each leaf's path, in leaf order, as ``jax.tree_util.keystr``
    writes it."""
    out: list[str] = []
    _paths(tree, "", out)
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and same-structure
    ``rest`` trees."""
    lv, td = flatten(tree)
    others = []
    for r in rest:
        rl, rtd = flatten(r)
        if rtd != td:
            raise ValueError(f"tree structures differ: {td} vs {rtd}")
        others.append(rl)
    return unflatten(td, [fn(*args) for args in zip(lv, *others)])
