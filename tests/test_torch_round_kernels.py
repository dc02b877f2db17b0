"""The round kernels' plain PyTorch versions against the JAX package's
Pallas round kernels, run in interpret mode on the CPU.

The Pallas kernels take one mask scalar per device; the port takes one
per rank.  So the reference runs once with the scalar true and once
false over the whole rank-stacked payload (its ⊕ is elementwise), and
the expected rows of each rank are taken from the run its mask selects.
Leaf sizes are no multiple of the 128-lane tile.  Tolerance 0 for the
elementwise monoids: the same IEEE operations on the same inputs.  For
affine, XLA's CPU backend fuses a_hi·b_lo + b_hi into one FMA while the
port rounds the product and the sum apart (as its CUDA kernel does, bit
for bit), so the two differ by one rounding of a unit-scale product:
|err| <= AFFINE_ATOL + AFFINE_RTOL·|ref|.  The port's affine combine is
also held bit for bit against the FMA-free numpy twin.
"""

import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import monoid as rmon
from repro.kernels import scan_engine as rse
from repro_torch import _tree
from repro_torch import device as tdev
from repro_torch.core import monoid as tmon
from repro_torch.kernels import scan_engine as tse

P = 5
MASK = np.array([1, 0, 1, 1, 0], np.int32)
DTYPES = (np.int32, np.int64, np.float32, ml_dtypes.bfloat16)
CASES = [(op, dt) for op in ("add", "mul", "max", "min", "xor")
         for dt in DTYPES
         if op != "xor" or np.issubdtype(dt, np.integer)]
CASES.append(("affine", np.float32))
IDS = [f"{op}-{np.dtype(dt).name}" for op, dt in CASES]
AFFINE_ATOL, AFFINE_RTOL = 1e-5, 1e-6


def _x64(dtype):
    """int64 on the JAX side needs x64, scoped to the call."""
    if np.dtype(dtype) == np.int64:
        return jax.enable_x64(True)
    return contextlib.nullcontext()


def _leaf(rng, dtype, shape):
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-(1 << 20), 1 << 20, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _payload(rng, op, dtype):
    """A rank-stacked payload tree: two same-dtype leaves (one dtype
    group, one launch), or the affine (a, b) pair."""
    if op == "affine":
        return (_leaf(rng, dtype, (P, 37)), _leaf(rng, dtype, (P, 37)))
    return {"u": _leaf(rng, dtype, (P, 37)),
            "v": _leaf(rng, dtype, (P, 3, 43))}


def _by_rank(true_out, false_out):
    """Row r from the mask-true run where MASK[r], else the false run."""
    def pick(t, f):
        t, f = np.asarray(t), np.asarray(f)
        sel = MASK.astype(bool).reshape((-1,) + (1,) * (t.ndim - 1))
        return np.where(sel, t, f)

    return jax.tree.map(pick, true_out, false_out)


def _assert_same(got, want, *, fma_rounding: bool = False):
    gl = [tdev.leaf_to_numpy(t) for t in _tree.leaves(got)]
    wl = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape
        if fma_rounding:
            np.testing.assert_allclose(g, w, rtol=AFFINE_RTOL,
                                       atol=AFFINE_ATOL)
        else:
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.fixture
def operands(request):
    op, dtype = request.param
    rng = np.random.default_rng(7)
    xs = [_payload(rng, op, dtype) for _ in range(3)]
    mask = torch.from_numpy(MASK)
    return (op, dtype, rmon.get(op), tmon.get(op), xs,
            [tdev.to_torch(x, "cpu") for x in xs], mask, op == "affine")


@pytest.mark.parametrize("operands", CASES, ids=IDS, indirect=True)
def test_tree_combine_matches_pallas(operands):
    op, dtype, rm, tm, xs, ts, mask, fma = operands
    with _x64(dtype):
        jx = [jax.tree.map(jnp.asarray, x) for x in xs]
        on = rse.tree_combine(rm, jx[0], jx[1], keep=True, interpret=True)
        off = rse.tree_combine(rm, jx[0], jx[1], keep=False,
                               interpret=True)
    _assert_same(tse.tree_combine(tm, ts[0], ts[1]), on, fma_rounding=fma)
    _assert_same(tse.tree_combine(tm, ts[0], ts[1], keep=mask),
                 _by_rank(on, off), fma_rounding=fma)
    if fma:
        _assert_same(tse.tree_combine(tm, ts[0], ts[1]),
                     rmon.NUMPY_OPS["affine"](xs[0], xs[1]))


@pytest.mark.parametrize("operands", CASES, ids=IDS, indirect=True)
def test_tree_exchange_matches_pallas(operands):
    op, dtype, rm, tm, xs, ts, mask, fma = operands
    with _x64(dtype):
        jx = [jax.tree.map(jnp.asarray, x) for x in xs]
        on = rse.tree_exchange(rm, jx[0], jx[1], True, interpret=True)
        off = rse.tree_exchange(rm, jx[0], jx[1], False, interpret=True)
    _assert_same(tse.tree_exchange(tm, ts[0], ts[1], mask),
                 _by_rank(on, off), fma_rounding=fma)


@pytest.mark.parametrize("operands", CASES, ids=IDS, indirect=True)
def test_tree_scan_reduce_matches_pallas(operands):
    op, dtype, rm, tm, xs, ts, mask, fma = operands
    with _x64(dtype):
        jx = [jax.tree.map(jnp.asarray, x) for x in xs]
        on = rse.tree_scan_reduce(rm, *jx, True, interpret=True)
        off = rse.tree_scan_reduce(rm, *jx, False, interpret=True)
    got = tse.tree_scan_reduce(tm, *ts, mask)
    _assert_same(got[0], _by_rank(on[0], off[0]), fma_rounding=fma)
    _assert_same(got[1], _by_rank(on[1], off[1]), fma_rounding=fma)


@pytest.mark.parametrize("operands", [c for c in CASES if c[0] != "affine"],
                         ids=[i for i in IDS if not i.startswith("affine")],
                         indirect=True)
def test_block_combine_matches_pallas(operands):
    op, dtype, rm, tm, xs, ts, mask, fma = operands
    a, b = xs[0]["v"], xs[1]["v"]
    ta, tb = ts[0]["v"], ts[1]["v"]
    with _x64(dtype):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        on = rse.block_combine(ja, jb, rm.leaf_op, keep=True,
                               interpret=True)
        off = rse.block_combine(ja, jb, rm.leaf_op, keep=False,
                                interpret=True)
    _assert_same(tse.block_combine(ta, tb, op), on)
    _assert_same(tse.block_combine(ta, tb, op, keep=mask),
                 _by_rank(on, off))


def test_broadcast_row_operand_matches_expanded():
    """A (1, n) operand reads as every rank's row (the native fold)."""
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(_leaf(rng, np.int64, (P, 37)))
    row = torch.from_numpy(_leaf(rng, np.int64, (1, 37)))
    mask = torch.from_numpy(MASK)
    got = tse.combine("xor", acc, row, mask=mask, else_a=True)
    want = torch.where(mask.bool().view(-1, 1), acc ^ row.expand_as(acc),
                       acc)
    assert torch.equal(got, want)


def test_leaf_identity_matches_reference():
    for name in ("add", "mul", "max", "min", "xor"):
        for tdt, ndt in ((torch.int32, np.int32), (torch.int64, np.int64),
                         (torch.float32, np.float32)):
            if name == "xor" and tdt == torch.float32:
                continue
            with jax.enable_x64(True):
                want = rse.leaf_identity(name, ndt)
            assert tse.leaf_identity(name, tdt) == want, (name, tdt)


def test_plain_path_counts_no_launch():
    tse.reset_launch_counts()
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    tse.combine("add", x, x)
    tse.exchange("add", x, x, torch.ones(3, dtype=torch.int32))
    counts = tse.launch_counts()
    assert {"combine", "exchange", "scan_reduce"} <= set(counts)
    assert not any(counts.values()), counts
