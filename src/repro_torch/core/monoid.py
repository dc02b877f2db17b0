"""Monoids over payload trees of tensors.

The paper's algorithms need only an associative ``op`` (not
commutativity) plus an identity, so that ranks that receive nothing
combine with the identity and the round stays uniform across ranks.

``op(lo, hi)``: ``lo`` covers the lower ranks; order is preserved by
every collective, so non-commutative monoids (affine, matmul) work.
The attributes mean what they mean in the JAX package's
``core/monoid.py``: ``commutative`` lets butterfly and scan_reduce
rounds elide a combine order, ``op_cost`` scales the planner's γ term,
``segmentable`` says ⊕ acts on aligned elements independently, and
``leaf_op`` names the elementwise ⊕ the round kernels serve.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch._tree import tree_map


@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    op: Callable[[Any, Any], Any]
    identity_like: Callable[[Any], Any]
    commutative: bool = False
    op_cost: float = 1.0
    segmentable: bool = True
    leaf_op: Callable | None = None

    def fold(self, items):
        items = list(items)
        if not items:
            raise ValueError("fold of empty sequence needs a shape witness")
        acc = items[0]
        for x in items[1:]:
            acc = self.op(acc, x)
        return acc


def _zeros_like(x):
    return tree_map(torch.zeros_like, x)


def _ones_like(x):
    return tree_map(torch.ones_like, x)


def extreme(dtype: torch.dtype, is_max: bool):
    """The identity scalar of max (``is_max``) or min at ``dtype``:
    ∓inf for floats (bf16 included), the integer limits otherwise."""
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


def _max_identity(x):
    return tree_map(lambda t: torch.full_like(t, extreme(t.dtype, True)), x)


def _min_identity(x):
    return tree_map(lambda t: torch.full_like(t, extreme(t.dtype, False)), x)


ADD = Monoid("add", lambda lo, hi: tree_map(torch.add, lo, hi),
             _zeros_like, commutative=True, leaf_op=torch.add)
MUL = Monoid("mul", lambda lo, hi: tree_map(torch.mul, lo, hi),
             _ones_like, commutative=True, leaf_op=torch.mul)
MAX = Monoid("max", lambda lo, hi: tree_map(torch.maximum, lo, hi),
             _max_identity, commutative=True, leaf_op=torch.maximum)
MIN = Monoid("min", lambda lo, hi: tree_map(torch.minimum, lo, hi),
             _min_identity, commutative=True, leaf_op=torch.minimum)
XOR = Monoid("xor", lambda lo, hi: tree_map(torch.bitwise_xor, lo, hi),
             _zeros_like, commutative=True, leaf_op=torch.bitwise_xor)


def affine_combine(lo, hi):
    """Composition of elementwise affine maps x -> a*x + b; ``lo`` is
    applied first:  (hi ∘ lo)(x) = (a_hi·a_lo)·x + (a_hi·b_lo + b_hi).

    THE one definition in the port: the affine round kernels compute
    exactly this, product and sum each rounded once (no fused
    multiply-add), so kernel and plain version agree bit for bit."""
    a_lo, b_lo = lo
    a_hi, b_hi = hi
    return (a_hi * a_lo, a_hi * b_lo + b_hi)


def _affine_identity(x):
    a, b = x
    return (torch.ones_like(a), torch.zeros_like(b))


AFFINE = Monoid("affine", affine_combine, _affine_identity,
                commutative=False, op_cost=2.0)


def _matmul_op(lo, hi):
    return tree_map(lambda l, h: torch.matmul(h, l), lo, hi)


def _matmul_identity(x):
    def one(t):
        eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
        return eye.expand(t.shape).clone()

    return tree_map(one, x)


MATMUL = Monoid("matmul", _matmul_op, _matmul_identity, commutative=False,
                op_cost=8.0, segmentable=False)


REGISTRY: dict[str, Monoid] = {
    m.name: m for m in (ADD, MUL, MAX, MIN, XOR, AFFINE, MATMUL)
}


def get(name_or_monoid) -> Monoid:
    if isinstance(name_or_monoid, Monoid):
        return name_or_monoid
    try:
        return REGISTRY[name_or_monoid]
    except KeyError:
        raise KeyError(
            f"unknown monoid {name_or_monoid!r}; known: {sorted(REGISTRY)}"
        ) from None
