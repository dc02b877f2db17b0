"""The port's schedule IR against the JAX package's, field for field.

Every builder and transform at p = 1..33 (S in {1, 2, 4, 8} where a
segment count applies): the schedules' fields and
``dataclasses.astuple`` of every step must be equal, and so must the
launch, pass, ⊕ and byte laws read off them.  Integers throughout, so
the tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import collectives as rcoll
from repro.core import schedule as rsch
from repro_torch.core import collectives as tcoll
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch

P_RANGE = range(1, 34)
SEGMENTS = (1, 2, 4, 8)
NBYTES = (0, 1, 7, 8, 1000, 1 << 20, (1 << 20) + 3)
BUILDERS = ("build_123", "build_1doubling", "build_two_op", "build_native",
            "build_halving", "build_quartering", "build_reduce_scatter",
            "build_hillis_steele", "build_butterfly", "build_scan_total")
EXCLUSIVE = ("build_123", "build_1doubling", "build_two_op",
             "build_native", "build_halving", "build_quartering",
             "build_reduce_scatter")


def _call(fn, *args, **kw):
    """The result, or the type of the exception it raised."""
    try:
        return fn(*args, **kw)
    except (ValueError, NotImplementedError, AssertionError) as e:
        return type(e).__name__


def view(s, mod):
    """Everything a schedule states and every law read off it."""
    if isinstance(s, str):
        return s
    steps = tuple(dataclasses.astuple(st) for st in s.steps)
    per_step = tuple(
        (st.is_round, st.ops)
        + tuple(st.op_count(c) for c in (False, True))
        + tuple(f(c, fused=fu) for f in (st.kernel_launches,
                                        st.kernel_passes)
                for c in (False, True) for fu in (False, True))
        + tuple(mod.step_wire_bytes(st, nb, s.n_segments) for nb in NBYTES)
        for st in s.steps)
    laws = (s.rounds, s.op_applications, s.allgathers, s.n_segments)
    for c in (False, True):
        laws += (s.op_count(c),)
        laws += tuple(mod.op_wire_bytes(s, nb, c) for nb in NBYTES)
        for fu in (False, True):
            laws += (s.kernel_launches(c, fused=fu),
                     s.kernel_passes(c, fused=fu))
            laws += tuple(mod.pass_wire_bytes(s, nb, c, fused=fu)
                          for nb in NBYTES)
    laws += tuple(mod.wire_bytes(s, nb) for nb in NBYTES)
    head = (s.algorithm, s.kind, s.p, s.init,
            tuple(dataclasses.astuple(g) for g in s.segments), s.axes,
            s.outputs)
    return head, steps, per_step, laws, s.describe()


def both(name, *args, **kw):
    return (view(_call(getattr(tsch, name), *args, **kw), tsch),
            view(_call(getattr(rsch, name), *args, **kw), rsch))


@pytest.mark.parametrize("builder", BUILDERS)
def test_builders_equal(builder):
    for p in P_RANGE:
        got, want = both(builder, p)
        assert got == want, (builder, p)


@pytest.mark.parametrize("S", SEGMENTS)
def test_ring_and_segment_transform_equal(S):
    for p in P_RANGE:
        got, want = both("build_ring", p, S)
        assert got == want, ("ring", p, S)
        for builder in ("build_123", "build_two_op"):
            t = _call(tsch.segment, getattr(tsch, builder)(p), S)
            r = _call(rsch.segment, getattr(rsch, builder)(p), S)
            assert view(t, tsch) == view(r, rsch), (builder, p, S)


@pytest.mark.parametrize("builder", EXCLUSIVE + ("build_ring",))
def test_with_total_equal(builder):
    for p in P_RANGE:
        t = _call(tsch.with_total, getattr(tsch, builder)(p))
        r = _call(rsch.with_total, getattr(rsch, builder)(p))
        assert view(t, tsch) == view(r, rsch), (builder, p)


@pytest.mark.parametrize("total", [False, True])
def test_compose_equal(total):
    for pi in (1, 2, 3, 5, 8):
        for po in (1, 2, 4, 7):
            if total:
                args = lambda m: (m.build_scan_total(pi),  # noqa: E731
                                  m.build_scan_total(po))
                fn = "compose_total"
            else:
                args = lambda m: (m.build_123(pi),  # noqa: E731
                                  m.build_butterfly(pi), m.build_two_op(po))
                fn = "compose"
            t = _call(getattr(tsch, fn), *args(tsch), minor_axis="y",
                      outer_axis="x")
            r = _call(getattr(rsch, fn), *args(rsch), minor_axis="y",
                      outer_axis="x")
            assert view(t, tsch) == view(r, rsch), (fn, pi, po)


def _payloads(p, rng):
    return [rng.integers(0, 100, (p, 3)).astype(np.int32),
            rng.integers(0, 100, (p, 2, 2)).astype(np.int32),
            rng.integers(0, 100, (p,)).astype(np.int32)]


def _layout_fields(lay):
    return (lay.dtypes, lay.shapes, lay.offsets, lay.totals, lay.n)


@pytest.mark.parametrize("builder", ("build_123", "build_two_op",
                                     "build_scan_total"))
def test_fuse_layout_and_packing_equal(builder):
    rng = np.random.default_rng(0)
    for p in range(2, 18):
        xs = _payloads(p, rng)
        tx = [torch.from_numpy(x) for x in xs]
        tl, rl = tsch.make_layout(tx, lead=1), rsch.make_layout(xs, lead=1)
        assert _layout_fields(tl) == _layout_fields(rl)
        t = tsch.fuse([getattr(tsch, builder)(p)], tl)
        r = rsch.fuse([getattr(rsch, builder)(p)], rl)
        assert view(t, tsch) == view(r, rsch), (builder, p)
        tp = tsch.pack_payloads(tl, tx, lead=1)
        rp = rsch.pack_payloads(rl, xs, xp=np, lead=1)
        assert np.array_equal(tp.numpy(), np.asarray(rp))
        back = tsch.unpack_payloads(tl, tp, lead=1)
        assert all(np.array_equal(b.numpy(), x) for b, x in zip(back, xs))


@pytest.mark.parametrize("builder", ("build_ring", "build_quartering",
                                     "build_reduce_scatter"))
def test_expected_round_bytes_equal(builder):
    per_rank = (np.zeros(37, np.int64), np.zeros((3, 5), np.float32))
    tper = tuple(torch.from_numpy(a) for a in per_rank)
    for p in range(2, 18):
        for S in (SEGMENTS if builder == "build_ring" else (1,)):
            args = (p, S) if builder == "build_ring" else (p,)
            t, r = getattr(tsch, builder)(*args), getattr(rsch, builder)(*args)
            assert tsch.expected_round_bytes(t, tper) == \
                rsch.expected_round_bytes(r, per_rank), (builder, p, S)


@pytest.mark.parametrize("kind", tsa.KINDS)
def test_expected_rounds_and_ops_equal(kind):
    for algo in tsa.algorithms(kind):
        for p in range(2, 34):
            for S in ((1, 2, 4, 8) if algo == "ring" else (1,)):
                for c in (False, True):
                    assert tcoll.expected_ops(
                        algo, p, kind=kind, segments=S, commutative=c) == \
                        rcoll.expected_ops(algo, p, kind=kind, segments=S,
                                           commutative=c)
                assert tcoll.expected_rounds(algo, p, kind=kind,
                                             segments=S) == \
                    rcoll.expected_rounds(algo, p, kind=kind, segments=S)
