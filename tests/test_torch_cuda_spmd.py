"""The worker pool on the card: ranks in processes on one card over
gloo, every message staged through pinned host memory, every ⊕ a round
kernel (marked ``cuda``; skipped where there is no card).  The pool's
outputs are bit for bit ``StackedExecutor``'s on the same card, every
process launches the IR's round kernels, and the staging buffers made
by the first run serve the next.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_spmd.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import scan_api as sa
from repro_torch.core import schedule as sch
from repro_torch.dist import WorkerPool

pytestmark = pytest.mark.cuda

P = 4
ROUND_KERNELS = ("combine", "exchange", "scan_reduce")


@pytest.fixture(scope="module")
def pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with WorkerPool(P, backend="gloo", device="cuda:0", timeout=120) as pl:
        yield pl


def _launches(res):
    return [sum(n for k in ROUND_KERNELS for n in ln.get(k, {}).values())
            for ln in res.launches]


def _stacked(sched, x, monoid):
    x = tuple(torch.from_numpy(v).cuda() for v in x) \
        if isinstance(x, tuple) else torch.from_numpy(x).cuda()
    out = sch.StackedExecutor("cuda").execute(sched, x, monoid)
    return tuple(t.cpu().numpy() for t in out) if isinstance(out, tuple) \
        else out.cpu().numpy()


@pytest.mark.parametrize("algo,segments", [
    ("123", 1), ("1doubling", 1), ("two_op", 1), ("native", 1),
    ("ring", 3), ("halving", 1), ("reduce_scatter", 1)])
def test_pool_xor_matches_stacked(pool, algo, segments):
    rng = np.random.default_rng(1)
    x = rng.integers(-(1 << 62), 1 << 62, (P, 1001), dtype=np.int64)
    pl = sa.plan(sa.ScanSpec(kind="exclusive", monoid="xor", algorithm=algo,
                             segments=segments), P, nbytes=x[0].nbytes)
    res = pool.run(pl.schedule(), x, monoid="xor")
    assert np.array_equal(res.outputs, _stacked(pl.schedule(), x, "xor"))
    ir = pl.schedule().kernel_launches(True, fused=True)
    assert _launches(res) == [ir] * P
    assert res.transport["staged_copies"] > 0


def test_pool_affine_grid_matches_stacked(pool):
    # ("pod", "data") = (2, 2): the inner butterfly is non-commutative,
    # so the affine exchange kernel runs in every process
    rng = np.random.default_rng(2)
    x = (rng.uniform(0.9, 1.1, (P, 4096)).astype(np.float32),
         (0.1 * rng.standard_normal((P, 4096))).astype(np.float32))
    pl = sa.plan(sa.ScanSpec(kind="exclusive", monoid="affine",
                             axis_name=("pod", "data")), (2, 2),
                 nbytes=8 * 4096)
    res = pool.run(pl.schedule(), x, monoid="affine")
    for got, want in zip(res.outputs, _stacked(pl.schedule(), x, "affine")):
        assert np.array_equal(got, want)
    assert all(ln.get("exchange", {}).get("affine", 0) > 0
               for ln in res.launches)
    assert _launches(res) == [pl.schedule().kernel_launches(
        False, fused=True)] * P


def test_staging_buffers_reused(pool):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 30, (P, 777), dtype=np.int64)
    sched = sa.plan(sa.ScanSpec(kind="exclusive", monoid="add",
                                algorithm="123"), P,
                    nbytes=x[0].nbytes).schedule()
    first = pool.run(sched, x)
    again = pool.run(sched, x, repeats=3)
    made = [m["staging_buffers"] for m in first.memory]
    assert all(n > 0 for n in made)
    assert [m["staging_buffers"] for m in again.memory] == made
    assert np.array_equal(first.outputs, again.outputs)
