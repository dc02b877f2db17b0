"""Blocks of ranks in processes on the card: a ``WorkerPool`` of 2
processes of 4 ranks each on one card over gloo, every crossing message
staged through pinned host memory, every ⊕ a round kernel over the
block (marked ``cuda``; skipped where there is no card).  The pool's
outputs are bit for bit ``StackedExecutor``'s on the same card, every
process launches the IR's round kernels, and the staging buffers made
by the first run serve the next.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_blocks.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import scan_api as sa
from repro_torch.core import schedule as sch
from repro_torch.dist import WorkerPool

pytestmark = pytest.mark.cuda

NPROCS, P = 2, 4
ROUND_KERNELS = ("combine", "exchange", "scan_reduce")


@pytest.fixture(scope="module")
def pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with WorkerPool(NPROCS, p_intra=P, backend="gloo", device="cuda:0",
                    timeout=120) as pl:
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


@pytest.mark.parametrize("algo,segments", [("123", 1), ("ring", 3)])
def test_block_pool_xor_matches_stacked(pool, algo, segments):
    rng = np.random.default_rng(1)
    x = rng.integers(-(1 << 62), 1 << 62, (pool.p, 1001), dtype=np.int64)
    pl = sa.plan(sa.ScanSpec(kind="exclusive", monoid="xor", algorithm=algo,
                             segments=segments), pool.p, nbytes=x[0].nbytes)
    sched = pl.schedule()
    res = pool.run(sched, x, monoid="xor")
    assert np.array_equal(res.outputs, _stacked(sched, x, "xor"))
    assert _launches(res) == [sched.kernel_launches(True, fused=True)] * NPROCS
    one = torch.from_numpy(x[0])
    assert (res.transport["msgs"], res.transport["bytes"]) == \
        sch.expected_messages(sched, one, ranks_per_proc=P)
    assert res.transport["staged_copies"] > 0


def test_block_pool_affine_hierarchical_matches_stacked(pool):
    # (proc, local) = (2, 4): the intra runs read rows in place, the inter
    # runs cross; the non-commutative butterfly runs the affine exchange
    rng = np.random.default_rng(2)
    x = (rng.uniform(0.9, 1.1, (pool.p, 4096)).astype(np.float32),
         (0.1 * rng.standard_normal((pool.p, 4096))).astype(np.float32))
    pl = sa.plan(sa.ScanSpec(kind="exclusive", monoid="affine",
                             axis_name=("proc", "local")), (NPROCS, P),
                 nbytes=8 * 4096)
    res = pool.run(pl.schedule(), x, monoid="affine")
    for got, want in zip(res.outputs, _stacked(pl.schedule(), x, "affine")):
        assert np.array_equal(got, want)
    assert _launches(res) == [pl.schedule().kernel_launches(
        False, fused=True)] * NPROCS
    assert all(ln.get("exchange", {}).get("affine", 0) > 0
               for ln in res.launches)


def test_block_staging_buffers_reused(pool):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 30, (pool.p, 777), dtype=np.int64)
    pl = sa.plan_hierarchical(sa.ScanSpec(kind="exclusive", monoid="add"),
                              p_inter=NPROCS, p_intra=P, nbytes=x[0].nbytes)
    first = pool.run(pl.schedule(), x)
    again = pool.run(pl.schedule(), x, repeats=3)
    made = [m["staging_buffers"] for m in first.memory]
    assert all(n > 0 for n in made)
    assert [m["staging_buffers"] for m in again.memory] == made
    assert np.array_equal(first.outputs, again.outputs)
    assert np.array_equal(first.outputs, _stacked(pl.schedule(), x, "add"))
