"""Peer rows read in place: the row-table operand of the round kernels.

A round's peer exchange on stacked ranks is a row gather: rank r
receives rank r−skip's row (a shift; zeros below skip) or rank r^skip's
(the butterfly).  The round kernels read such an operand in place
through an int32 row table (``scan_engine.Rows``; −1 reads zeros).  On
the CPU the wrappers gather it and run the plain versions, so these
tests hold, bit for bit:

  * ``tree_combine`` / ``tree_exchange`` / ``tree_scan_reduce`` with a
    row-table operand against a gather written out row by row plus the
    plain version, for every ⊕ and dtype the round kernels serve;
  * ``gather_rows`` against the executor's own gathers;
  * ``StackedExecutor`` (which now hands the shift, exchange and
    scan_reduce rounds such operands) against the JAX package's
    ``SimulatorExecutor``, outputs and ``collect_stats()``;
  * ``monoid_chunk_regime``: the look-back regime exactly for an
    integer ⊕ at D = 1.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import monoid as rmon
from repro.core import scan_api as rsa
from repro.core import schedule as rsch
from repro_torch import _tree
from repro_torch import device as tdev
from repro_torch.core import monoid as tmon
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.kernels import scan_engine as se

PS = (2, 3, 5, 8, 17)
OPS = ("add", "mul", "max", "min", "xor")
DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64,
          torch.bfloat16)
CASES = [(op, dt) for op, dt in itertools.product(OPS, DTYPES)
         if se.kernel_serves(op, dt)]
CASES += [("affine", torch.float32), ("affine", torch.float64)]


def _tables(p):
    """Shifts by 1 (−1 below) and by 3 (r − 3 as the executor builds it:
    any negative entry reads zeros), the butterfly's r^2 (partners past
    p read zeros), and every row −1, as int32 (p,) tensors."""
    r = np.arange(p)
    tabs = [np.where(r >= 1, r - 1, -1), r - 3,
            np.where((r ^ 2) < p, r ^ 2, -1), np.full(p, -1)]
    return [torch.from_numpy(t.astype(np.int32)) for t in tabs]


def _leaf(rng, dtype, shape):
    if dtype in (torch.int32, torch.int64):
        return torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, shape)) \
            .to(dtype)
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _payload(rng, op, dtype, p):
    """Two leaves of one dtype (one launch group, concatenated along the
    row), or the affine (a, b) pair."""
    if op == "affine":
        return (_leaf(rng, dtype, (p, 7)), _leaf(rng, dtype, (p, 7)))
    return {"u": _leaf(rng, dtype, (p, 3)), "v": _leaf(rng, dtype, (p, 2, 2))}


def _gathered(tree, src):
    """Rank r's rows written out one by one: row src[r], or zeros."""
    def one(t):
        rows = [t[s] if s >= 0 else torch.zeros_like(t[0])
                for s in src.tolist()]
        return torch.stack(rows)

    return _tree.tree_map(one, tree)


def _plain(fn, op, *trees):
    """The plain version applied per leaf (the affine pair as one)."""
    if op == "affine":
        return fn(*trees)
    keys = sorted(trees[0])
    outs = [fn(*(t[k].reshape(t[k].shape[0], -1) for t in trees))
            for k in keys]
    if isinstance(outs[0], tuple):
        return tuple({k: o[i].reshape(trees[0][k].shape)
                      for k, o in zip(keys, outs)} for i in range(2))
    return {k: o.reshape(trees[0][k].shape) for k, o in zip(keys, outs)}


def _same(got, want):
    gl, wl = _tree.leaves(got), _tree.leaves(want)
    return len(gl) == len(wl) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(gl, wl))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("op,dtype", CASES, ids=lambda v: str(v))
def test_row_table_operand_equals_gather_then_plain(op, dtype, p):
    m = tmon.get(op)
    rng = np.random.default_rng(p)
    x, w, pf = (_payload(rng, op, dtype, p) for _ in range(3))
    mask = torch.from_numpy(rng.integers(0, 2, p).astype(np.int32))
    for src in _tables(p):
        rows, g = se.Rows(x, src), _gathered(x, src)
        assert _same(se.gather_rows(rows), g)
        for keep, else_lo in ((None, False), (mask, False), (mask, True)):
            assert _same(
                se.tree_combine(m, rows, w, keep=keep, else_lo=else_lo),
                _plain(lambda a, b: se.combine_plain(
                    op, a, b, mask=keep, else_a=else_lo), op, g, w))
        assert _same(se.tree_combine(m, w, rows),
                     _plain(lambda a, b: se.combine_plain(op, a, b), op,
                            w, g))
        assert _same(se.tree_exchange(m, rows, w, mask),
                     _plain(lambda a, b: se.exchange_plain(op, a, b, mask),
                            op, g, w))
        assert _same(se.tree_scan_reduce(m, rows, w, pf, mask),
                     _plain(lambda a, b, c: se.scan_reduce_plain(
                         op, a, b, c, mask, commutative=m.commutative),
                            op, g, w, pf))


@pytest.mark.parametrize("p", PS)
def test_gather_rows_equals_the_executor_gathers(p):
    rng = np.random.default_rng(p)
    tree = (_leaf(rng, torch.float32, (p, 4, 3)),
            _leaf(rng, torch.bfloat16, (p, 5)))
    r = torch.arange(p)
    for skip in range(1, p + 1):
        shift = (r - skip).to(torch.int32)
        assert _same(se.gather_rows(se.Rows(tree, shift)),
                     tsch._shift_rows(tree, skip))
    skip = 1
    while skip < p:
        perm = r ^ skip
        if int(perm.max()) < p:
            assert _same(se.gather_rows(se.Rows(tree, perm.to(torch.int32))),
                         tsch._permute(tree, perm))
        skip *= 2


def test_bad_row_table_fails_in_the_cpu_gather():
    """A CPU operand is gathered, so a row past p fails there as an
    index error (the kernels check the table's shape and dtype only)."""
    x = torch.arange(12, dtype=torch.int64).reshape(4, 3)
    with pytest.raises(IndexError):
        se.combine("add", se.Rows(x, torch.tensor([0, 1, 2, 9],
                                                  dtype=torch.int32)), x)


# ---------------------------------------------------------------------------
# The executor hands the shift, exchange and scan_reduce rounds row tables
# ---------------------------------------------------------------------------

EXEC_ALGOS = [("exclusive", "123"), ("exclusive", "1doubling"),
              ("exclusive", "two_op"), ("scan_total", "fused_doubling"),
              ("scan_total", "123"), ("allreduce", "butterfly")]
EXEC_MONOIDS = ("add", "xor", "max", "affine")


def _exec_payload(name, p, rng):
    if name == "affine":
        return (rng.standard_normal((p, 5)), rng.standard_normal((p, 5)))
    if name == "max":
        return rng.standard_normal((p, 5))
    return rng.integers(0, 1 << 30, (p, 5)).astype(np.int64)


def _stats(st):
    return (st.rounds, st.op_applications, st.allgathers,
            tuple(st.bytes_per_round))


class _Spy:
    """Counts the row-table operands the tree hooks receive."""

    def __init__(self, monkeypatch):
        self.rows = 0
        for name in ("tree_combine", "tree_exchange", "tree_scan_reduce"):
            monkeypatch.setattr(se, name, self._wrap(getattr(se, name)))

    def _wrap(self, fn):
        def spy(m, *trees, **kw):
            self.rows += sum(isinstance(t, se.Rows) for t in trees)
            return fn(m, *trees, **kw)

        return spy


@pytest.mark.parametrize("kind,algo", EXEC_ALGOS,
                         ids=[f"{k}-{a}" for k, a in EXEC_ALGOS])
def test_executor_with_row_tables_matches_simulator(monkeypatch, kind, algo):
    spy = _Spy(monkeypatch)
    for name in EXEC_MONOIDS:
        for p in (2, 3, 4, 5, 8, 13, 16, 17):
            tsched = tsa.get_algorithm(kind, algo).schedule(p, 1)
            rsched = rsa.get_algorithm(kind, algo).schedule(p, 1)
            x = _exec_payload(name, p, np.random.default_rng(p))
            with jax.enable_x64(True):
                with rsch.collect_stats() as rst:
                    want = rsch.SimulatorExecutor().execute(rsched, x,
                                                            rmon.get(name))
            m = tmon.get(name)
            before = spy.rows
            with tsch.collect_stats() as tst:
                got = tsch.StackedExecutor("cpu").execute(tsched, x, m)
            gl = [tdev.leaf_to_numpy(t) for t in _tree.leaves(got)]
            wl = [np.asarray(v) for v in jax.tree.leaves(want)]
            assert len(gl) == len(wl) and all(
                g.dtype == v.dtype and np.array_equal(g, v)
                for g, v in zip(gl, wl)), (algo, name, p)
            assert _stats(tst) == _stats(rst), (algo, name, p)
            assert (tst.kernel_launches, tst.hbm_passes) == (
                tsched.kernel_launches(m.commutative, fused=True),
                tsched.kernel_passes(m.commutative, fused=True))
            peer_rounds = sum(
                1 for st in tsched.steps
                if (st.kind == "shift" and st.combine == "op")
                or st.kind in ("exchange", "scan_reduce"))
            assert (spy.rows > before) == (peer_rounds > 0), (algo, name, p)


def test_baseline_executor_keeps_its_gathers(monkeypatch):
    """fused=False is the per-leaf baseline: it gathers as before and
    hands no row table on."""
    spy = _Spy(monkeypatch)
    x = np.arange(40, dtype=np.int64).reshape(8, 5)
    sched = tsa.get_algorithm("exclusive", "123").schedule(8, 1)
    got = tsch.StackedExecutor("cpu", fused=False).execute(sched, x, "add")
    want = np.concatenate([np.zeros((1, 5), np.int64),
                           np.cumsum(x, axis=0)[:-1]])
    assert np.array_equal(tdev.leaf_to_numpy(got), want)
    assert spy.rows == 0


# ---------------------------------------------------------------------------
# monoid_chunk's two regimes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", (1, 2, 37, 8192))
@pytest.mark.parametrize("op,dtype", [c for c in CASES if c[0] != "affine"],
                         ids=lambda v: str(v))
def test_monoid_chunk_regime_is_lookback_exactly_for_int_d1(op, dtype, D):
    want = "A" if (D == 1 and dtype in (torch.int32, torch.int64)) else "B"
    assert se.monoid_chunk_regime(op, dtype, D) == want
