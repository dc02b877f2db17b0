"""The port's monoids and oracle against the JAX package's.

Inputs are numpy arrays made from a seed; both packages see the same
ones.  Ops and identities must agree exactly (tolerance 0: elementwise
IEEE operations on the same inputs), bf16 through ``ml_dtypes``.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import monoid as rmon
from repro.core import oracle as roracle
from repro_torch import device as tdev
from repro_torch.core import monoid as tmon
from repro_torch.core import oracle as toracle

DTYPES = (np.int32, np.int64, np.float32, ml_dtypes.bfloat16)
CASES = [(name, dt) for name in ("add", "mul", "max", "min", "xor")
         for dt in DTYPES
         if name != "xor" or np.issubdtype(dt, np.integer)]


def _sample(rng, dtype, shape=(3, 37)):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-(1 << 20), 1 << 20, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _same(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def _ref_identity(name, x):
    """The reference's identity: its numpy twin, or (bf16, which numpy
    does not count as floating) the JAX monoid's own."""
    if x.dtype == ml_dtypes.bfloat16:
        return np.asarray(rmon.get(name).identity_like(jnp.asarray(x)))
    return rmon.NUMPY_IDENTITY[name](x)


@pytest.mark.parametrize("name,dtype", CASES,
                         ids=[f"{n}-{np.dtype(d).name}" for n, d in CASES])
def test_elementwise_op_and_identity_match_numpy_twins(name, dtype):
    rng = np.random.default_rng(0)
    lo, hi = _sample(rng, dtype), _sample(rng, dtype)
    m = tmon.get(name)
    got = m.op(tdev.leaf_to_torch(lo, "cpu"), tdev.leaf_to_torch(hi, "cpu"))
    want = rmon.NUMPY_OPS[name](lo, hi)
    assert _same(tdev.leaf_to_numpy(got), np.asarray(want, dtype=dtype))
    ident = m.identity_like(tdev.leaf_to_torch(lo, "cpu"))
    assert _same(tdev.leaf_to_numpy(ident), _ref_identity(name, lo))
    # the identity is neutral on both sides
    x = tdev.leaf_to_torch(lo, "cpu")
    assert torch.equal(m.op(ident, x), x) and torch.equal(m.op(x, ident), x)


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_affine_combine_and_identity_match(dtype):
    rng = np.random.default_rng(1)
    lo = (_sample(rng, dtype), _sample(rng, dtype))
    hi = (_sample(rng, dtype), _sample(rng, dtype))
    got = tmon.AFFINE.op(tdev.to_torch(lo, "cpu"), tdev.to_torch(hi, "cpu"))
    want = rmon.NUMPY_OPS["affine"](lo, hi)
    for g, w in zip(got, want):
        assert _same(tdev.leaf_to_numpy(g), w)
    ident = tmon.AFFINE.identity_like(tdev.to_torch(lo, "cpu"))
    for g, w in zip(ident, rmon.NUMPY_IDENTITY["affine"](lo)):
        assert _same(tdev.leaf_to_numpy(g), w)


def test_matmul_op_and_identity_match():
    rng = np.random.default_rng(2)
    lo, hi = (rng.integers(-2, 3, (4, 3, 3)).astype(np.float64)
              for _ in range(2))
    got = tmon.MATMUL.op(torch.from_numpy(lo), torch.from_numpy(hi))
    assert _same(got.numpy(), rmon.NUMPY_OPS["matmul"](lo, hi))
    ident = tmon.MATMUL.identity_like(torch.from_numpy(lo))
    assert _same(ident.numpy(), rmon.NUMPY_IDENTITY["matmul"](lo))


@pytest.mark.parametrize("name", sorted(rmon.REGISTRY))
def test_monoid_attributes_match(name):
    r, t = rmon.get(name), tmon.get(name)
    assert (t.name, t.commutative, t.op_cost, t.segmentable) == \
        (r.name, r.commutative, r.op_cost, r.segmentable)
    assert (t.leaf_op is None) == (r.leaf_op is None)


def test_bf16_and_int64_extremes():
    assert tmon.extreme(torch.bfloat16, True) == float("-inf")
    assert tmon.extreme(torch.bfloat16, False) == float("inf")
    assert tmon.extreme(torch.int64, True) == np.iinfo(np.int64).min
    assert tmon.extreme(torch.int64, False) == np.iinfo(np.int64).max
    x = torch.zeros(3, dtype=torch.bfloat16)
    assert torch.isinf(tmon.MAX.identity_like(x)).all()


P_RANGE = range(1, 130)


@pytest.mark.parametrize("fn", ["q_123", "rounds_1doubling",
                                "rounds_two_op", "rounds_halving",
                                "rounds_quartering",
                                "rounds_reduce_scatter"])
def test_round_laws_equal(fn):
    for p in P_RANGE:
        assert getattr(toracle, fn)(p) == getattr(roracle, fn)(p), (fn, p)


@pytest.mark.parametrize("fn", ["skips_123", "skips_1doubling",
                                "skips_two_op"])
def test_skips_equal(fn):
    for p in P_RANGE:
        assert getattr(toracle, fn)(p) == getattr(roracle, fn)(p), (fn, p)


@pytest.mark.parametrize("algo", ["123", "1doubling", "two_op"])
def test_oracle_verify_equal(algo):
    for p in range(1, 40):
        assert dataclasses.astuple(toracle.verify(p, algo)) == \
            dataclasses.astuple(roracle.verify(p, algo))
