"""Multi-axis (composed, hierarchical, fused) scans on stacked ranks.

``StackedExecutor(device="cpu")`` runs composed schedules over the flat
ranks, row-major over ``sched.axes``, each run of steps folded to its
axis.  It is held against the JAX package's ``SimulatorExecutor`` on the
same schedule (planned by both packages under the reference's default
constants, so the IR is the same step for step): integer outputs bit for
bit, affine within 1e-10 relative, and ``collect_stats()`` equal
(rounds, ⊕, all-gathers, ``bytes_per_round``; kernel launches and passes
equal to the IR's).  The cases are ``tests/test_compose_fuse.py``'s, and
``scan`` / ``scan_with_total`` / ``fused_scan`` on one leading rank
dimension per axis.
"""

import dataclasses

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

AFFINE_RTOL = 1e-10
_R = rsa.DEFAULT_COST_MODEL
REF_COST = tsa.CostModel(alpha=_R.alpha, beta=_R.beta, gamma=_R.gamma)


def _plans(spec_kw, ps, nbytes):
    """The port's and the reference's plans of one multi-axis spec under
    the reference's default constants; their schedules must agree."""
    tp = tsa.plan(tsa.ScanSpec(**spec_kw), ps, nbytes=nbytes,
                  cost_model=REF_COST)
    rp = rsa.plan(rsa.ScanSpec(**spec_kw), ps, nbytes=nbytes)
    ts, rs = tp.schedule(), rp.schedule()
    assert tp.algorithm == rp.algorithm
    assert ts.axes == rs.axes and ts.p == rs.p
    assert [dataclasses.astuple(s) for s in ts.steps] == \
        [dataclasses.astuple(s) for s in rs.steps]
    return tp, ts, rs


def _stats(st):
    return (st.rounds, st.op_applications, st.allgathers,
            tuple(st.bytes_per_round))


def _same(got, want, name):
    gl = [tdev.leaf_to_numpy(t) for t in _tree.leaves(got)]
    wl = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype
        if name == "affine":
            np.testing.assert_allclose(g, w, rtol=AFFINE_RTOL, atol=0)
        else:
            assert np.array_equal(g, w)


def _check(tsched, rsched, x, name, modes=(True, False)):
    """Port executor (fused and baseline) against the simulator."""
    with jax.enable_x64(True):
        with rsch.collect_stats() as rst:
            want = rsch.SimulatorExecutor().execute(rsched, x,
                                                    rmon.get(name))
    m = tmon.get(name)
    for fused in modes:
        with tsch.collect_stats() as tst:
            got = tsch.StackedExecutor("cpu", fused=fused).execute(
                tsched, x, m)
        _same(got, want, name)
        assert _stats(tst) == _stats(rst), (tsched.algorithm, fused)
        assert (tst.kernel_launches, tst.hbm_passes) == (
            rsched.kernel_launches(m.commutative, fused=fused),
            rsched.kernel_passes(m.commutative, fused=fused))
    return want


def _exclusive_ref(x):
    ref = np.zeros_like(x)
    ref[1:] = np.cumsum(x[:-1], axis=0)
    return ref


@pytest.mark.parametrize("p_out", (2, 3))
def test_composed_matches_simulator_and_legacy(p_out):
    for p_in in range(2, 18):
        p = p_out * p_in
        x = np.arange(p * 4, dtype=np.int64).reshape(p, 4) ** 2 % 100003
        pl, ts, rs = _plans(dict(kind="exclusive", algorithm="auto",
                                 axis_name=("A", "B")), (p_out, p_in), 32)
        assert pl.algorithm.startswith("composite(")
        want = _check(ts, rs, x, "add")
        assert np.array_equal(want, _exclusive_ref(x))


def test_three_axes_noncommutative_affine():
    ps = (2, 3, 4)
    p = int(np.prod(ps))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((p, 8)), rng.standard_normal((p, 8)))
    _, ts, rs = _plans(dict(kind="exclusive", algorithm="auto",
                            monoid="affine", axis_name=("A", "B", "C")),
                       ps, 128)
    assert ts.axes == (("A", 2), ("B", 3), ("C", 4))
    ga, gb = _check(ts, rs, x, "affine")
    oa, ob = np.ones_like(x[0]), np.zeros_like(x[1])
    ca, cb = np.ones(8), np.zeros(8)
    for r in range(p):
        oa[r], ob[r] = ca, cb
        ca, cb = x[0][r] * ca, x[0][r] * cb + x[1][r]
    np.testing.assert_allclose(ga, oa, rtol=1e-12)
    np.testing.assert_allclose(gb, ob, rtol=1e-12)


@pytest.mark.parametrize("nbytes,inner", ((2 << 20, "ring"),
                                          (1 << 20, "quartering")))
def test_segmented_and_block_inner_stages(nbytes, inner):
    pl, ts, rs = _plans(dict(kind="exclusive", algorithm="auto",
                             axis_name=("A", "B")), (2, 12), nbytes)
    assert pl.sub_plans[0].algorithm == inner
    if inner == "ring":
        assert pl.sub_plans[0].segments > 1
    # S does not divide a rank's 2·S + 3 elements: each rank's part of
    # each group is split on its own, so the bytes equal the IR's law
    S = max(pl.sub_plans[0].segments, 8)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 30, (24, 2 * S + 3)).astype(np.int64)
    _check(ts, rs, x, "add")
    res = tsch.verify_plan(pl)
    assert res["ok"], res


def test_scan_total_multi_axis():
    pl, ts, rs = _plans(dict(kind="scan_total", algorithm="auto",
                             axis_name=("pod", "data")), (2, 8), 16)
    assert len(pl.sub_plans) == 2 and pl.rounds == 4
    for name in ("add", "affine"):
        x = tsch._witness_payload(name, 16, 5, 3)
        _check(ts, rs, x, name)
    res = tsch.verify_plan(pl)
    assert res["ok"], res


@pytest.mark.parametrize("kind", ("exclusive", "scan_total"))
def test_fused_multi_axis_schedule(kind):
    ps = (2, 4)
    p = 8
    _, ts, rs = _plans(dict(kind=kind, algorithm="auto",
                            axis_name=("x", "y")), ps, 64)
    rng = np.random.default_rng(4)
    xs = [rng.integers(0, 1 << 30, (p, 3)).astype(np.int64),
          rng.integers(0, 1 << 30, (p, 2, 2)).astype(np.int64),
          rng.integers(0, 1 << 30, (p,)).astype(np.int64)]
    tl = tsch.make_layout([torch.from_numpy(x) for x in xs], lead=1)
    rl = rsch.make_layout(xs, lead=1)
    _check(tsch.fuse([ts], tl), rsch.fuse([rs], rl), xs, "add")


def test_scan_entry_points_take_per_axis_leading_dims():
    ex = tsch.StackedExecutor("cpu")
    p_inter, p_intra = tsa.factor_ranks(24, 3)
    assert (p_inter, p_intra) == (3, 8)
    rng = np.random.default_rng(5)
    xn = rng.integers(0, 1 << 20, (p_inter, p_intra, 5)).astype(np.int64)
    flat = xn.reshape(24, 5)
    spec = tsa.ScanSpec(kind="exclusive", monoid="add", algorithm="auto")
    pl = tsa.plan_hierarchical(spec, p_inter=p_inter, p_intra=p_intra,
                               nbytes=40)
    hspec = spec.over(("proc", "local"))
    with tsch.collect_stats() as st:
        got = tsa.scan(torch.from_numpy(xn), hspec, executor=ex)
    assert tuple(got.shape) == xn.shape
    assert np.array_equal(got.numpy().reshape(24, 5), _exclusive_ref(flat))
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    pre, tot = tsa.scan_with_total(torch.from_numpy(xn), hspec, executor=ex)
    assert np.array_equal(pre.numpy().reshape(24, 5), _exclusive_ref(flat))
    assert np.array_equal(tot.numpy(),
                          np.broadcast_to(flat.sum(0), xn.shape))
    ys = [xn, xn[..., :2] * 3]
    outs = tsa.fused_scan([(torch.from_numpy(y), hspec) for y in ys],
                          executor=ex)
    for o, y in zip(outs, ys):
        assert tuple(o.shape) == y.shape
        assert np.array_equal(o.numpy().reshape(24, -1),
                              _exclusive_ref(y.reshape(24, -1)))
    # a single-axis spec still reads p off the one leading dimension
    one = tsa.scan(torch.from_numpy(flat), spec, executor=ex)
    assert np.array_equal(one.numpy(), _exclusive_ref(flat))
    with pytest.raises(ValueError):  # leaves disagree on the rank grid
        tsa.scan((torch.zeros(3, 8, 2), torch.zeros(3, 4, 2)), hspec,
                 executor=ex)
    with pytest.raises(ValueError):
        tsa.factor_ranks(24, 5)


@pytest.mark.parametrize("name", ("xor", "add", "max"))
def test_verify_composed_plans(name):
    for ps in ((2, 3), (3, 5), (2, 2, 3)):
        axes = ("a", "b", "c")[:len(ps)]
        for kind in ("exclusive", "scan_total"):
            pl = tsa.plan(tsa.ScanSpec(kind=kind, monoid=name,
                                       axis_name=axes), ps, nbytes=64)
            res = tsch.verify_plan(pl)
            assert res["ok"], (ps, kind, res)
