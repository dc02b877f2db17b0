"""The stacked-rank executor against the JAX package's simulator.

``StackedExecutor(device="cpu")``, fused and baseline, runs every
registered algorithm at p = 2..17 over add, max, xor, affine and matmul
(ring S in {1, 2, 4, 8}); outputs must equal ``SimulatorExecutor``'s bit
for bit (the same IEEE operations in the same order), and the recorded
stats must equal the reference's and the IR's.
"""

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

MONOIDS = ("add", "max", "xor", "affine", "matmul")
BLOCK = ("halving", "quartering", "reduce_scatter")
ALGOS = [(kind, algo) for kind in tsa.KINDS for algo in tsa.algorithms(kind)]


def _payload(name, p, rng):
    if name == "matmul":
        return rng.integers(-1, 2, (p, 3, 3)).astype(np.float64)
    if name == "affine":
        return (rng.standard_normal((p, 5)), rng.standard_normal((p, 5)))
    if name == "max":
        return rng.standard_normal((p, 5))
    return rng.integers(0, 1 << 30, (p, 5)).astype(np.int64)


def _stats(st):
    return (st.rounds, st.op_applications, st.allgathers,
            tuple(st.bytes_per_round))


def _same(got, want):
    gl = [tdev.leaf_to_numpy(t) for t in _tree.leaves(got)]
    wl = [np.asarray(w) for w in jax.tree.leaves(want)]
    return len(gl) == len(wl) and all(
        g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
        for g, w in zip(gl, wl))


def _check(tsched, rsched, x, name):
    with jax.enable_x64(True):
        with rsch.collect_stats() as rst:
            want = rsch.SimulatorExecutor().execute(rsched, x,
                                                    rmon.get(name))
    m = tmon.get(name)
    for fused in (True, False):
        with tsch.collect_stats() as tst:
            got = tsch.StackedExecutor("cpu", fused=fused).execute(
                tsched, x, m)
        assert _same(got, want), (tsched.algorithm, name, fused)
        assert _stats(tst) == _stats(rst), (tsched.algorithm, name, fused)
        served = m.leaf_op is not None or m.name == "affine"
        launches = tsched.kernel_launches(m.commutative, fused=fused)
        passes = tsched.kernel_passes(m.commutative, fused=fused)
        assert (tst.kernel_launches, tst.hbm_passes) == \
            ((launches, passes) if served else (0, 0))


@pytest.mark.parametrize("kind,algo", ALGOS,
                         ids=[f"{k}-{a}" for k, a in ALGOS])
def test_stacked_executor_bit_identical_to_simulator(kind, algo):
    for name in MONOIDS:
        if name == "matmul" and (algo in BLOCK or algo == "ring"):
            continue  # row-block and segmented forms need segmentable ⊕
        for p in range(2, 18):
            for S in ((1, 2, 4, 8) if algo == "ring" else (1,)):
                rng = np.random.default_rng(p * 31 + S)
                x = _payload(name, p, rng)
                _check(tsa.get_algorithm(kind, algo).schedule(p, S),
                       rsa.get_algorithm(kind, algo).schedule(p, S), x,
                       name)


@pytest.mark.parametrize("builder", ("build_123", "build_two_op",
                                     "build_scan_total"))
def test_fused_layout_execution_matches_simulator(builder):
    for p in range(2, 18):
        rng = np.random.default_rng(p)
        xs = [rng.integers(0, 1 << 30, (p, 3)).astype(np.int64),
              rng.integers(0, 1 << 30, (p, 2, 2)).astype(np.int64),
              rng.integers(0, 1 << 30, (p,)).astype(np.int64)]
        tl = tsch.make_layout([torch.from_numpy(x) for x in xs], lead=1)
        rl = rsch.make_layout(xs, lead=1)
        _check(tsch.fuse([getattr(tsch, builder)(p)], tl),
               rsch.fuse([getattr(rsch, builder)(p)], rl), xs, "add")


def test_multi_axis_schedule_raises():
    sched = tsch.compose(tsch.build_123(2), tsch.build_butterfly(2),
                         tsch.build_123(2), minor_axis="y", outer_axis="x")
    x = torch.zeros((4, 3), dtype=torch.int64)
    with pytest.raises(NotImplementedError):
        tsch.StackedExecutor("cpu").execute(sched, x, "add")


@pytest.mark.parametrize("kind", tsa.KINDS)
def test_verify_plan_and_fused_verify(kind):
    for algo in tsa.algorithms(kind):
        for p in (2, 5, 8, 13):
            for name in ("add", "affine", "max"):
                pl = tsa.plan(tsa.ScanSpec(kind=kind, monoid=name,
                                           algorithm=algo), p, nbytes=64)
                res = tsch.verify_plan(pl)
                assert res["ok"], res
    fp = tsa.plan_fused([tsa.ScanSpec(kind=kind, monoid="add")] * 3, 6,
                        [8, 16, 24])
    res = fp.verify()
    assert res["ok"] and res["correct"], res
