"""The scan across OS processes: ``SPMDExecutor`` in a ``WorkerPool``.

Each rank is a process of a ``torch.distributed`` gloo group on the CPU
(``device="cpu"``: the round kernels' plain versions).  Every case runs
one schedule three ways: through the pool, through the JAX package's
``SimulatorExecutor`` and through its message-passing
``run_ranks_threaded`` on a ``LocalTransport``.  The pool must give the
simulator's outputs (integers bit for bit, float64 affine and matmul
within rtol 1e-10 and atol 1e-12), rank 0 its stats (rounds, ⊕,
all-gathers, ``bytes_per_round``), every rank the IR's kernel launches
and HBM passes, and its summed point-to-point messages and bytes must
equal the transport's and ``schedule.expected_messages``.  The
transport carries all-gathers and broadcasts as messages through a
group root, where the pool calls ``all_gather``: those are counted
apart on both sides (:func:`_root_traffic`).

The cases are ``tests/test_core_spmd.py``'s and ``tests/test_dist.py``'s
at p in {2, 3, 5, 8}, one pool a p for the whole module (spawning takes
seconds), each with a timeout of 60 s.  Plans are made by both packages
under the reference's default constants, so the IR is the same.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import monoid as rmon
from repro.core import scan_api as rsa
from repro.core import schedule as rsch
from repro.dist import LocalTransport, run_ranks_threaded
from repro_torch import device as tdev
from repro_torch.core import monoid as tmon
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.dist import WorkerPool, run_plan
from repro_torch.kernels import scan_engine as se

PS = (2, 3, 5, 8)
TIMEOUT = 60
RTOL, ATOL = 1e-10, 1e-12
EXCLUSIVE = ("123", "1doubling", "two_op", "native", "ring", "halving",
             "quartering", "reduce_scatter")
GRIDS = {2: (2, 1), 3: (1, 3), 5: (5, 1), 8: (2, 4)}  # ("pod", "data")
_R = rsa.DEFAULT_COST_MODEL
REF_COST = tsa.CostModel(alpha=_R.alpha, beta=_R.beta, gamma=_R.gamma)
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module", params=PS, ids=lambda p: f"p{p}")
def pool(request):
    with WorkerPool(request.param, backend="gloo", device="cpu",
                    timeout=TIMEOUT) as pl:
        yield pl


def _witness(name, p, n, seed):
    rng = np.random.default_rng(seed)
    if name == "affine":
        return (rng.standard_normal((p, n)), rng.standard_normal((p, n)))
    if name == "matmul":
        return rng.standard_normal((p, 3, 3)) * 0.5
    return rng.integers(0, 1 << 30, size=(p, n)).astype(np.int64)


def _plans(spec_kw, ps, nbytes):
    """The port's and the reference's schedules of one spec; equal."""
    ts = tsa.plan(tsa.ScanSpec(**spec_kw), ps, nbytes=nbytes,
                  cost_model=REF_COST).schedule()
    rs = rsa.plan(rsa.ScanSpec(**spec_kw), ps, nbytes=nbytes).schedule()
    assert (ts.algorithm, ts.p, ts.axes) == (rs.algorithm, rs.p, rs.axes)
    assert [dataclasses.astuple(s) for s in ts.steps] == \
        [dataclasses.astuple(s) for s in rs.steps]
    return ts, rs


def _hier(p_inter, p_intra, nbytes):
    spec = dict(kind="exclusive", monoid="add")
    ts = tsa.plan_hierarchical(tsa.ScanSpec(**spec), p_inter=p_inter,
                               p_intra=p_intra, nbytes=nbytes,
                               cost_model=REF_COST).schedule()
    rs = rsa.plan_hierarchical(rsa.ScanSpec(**spec), p_inter=p_inter,
                               p_intra=p_intra, nbytes=nbytes).schedule()
    assert [dataclasses.astuple(s) for s in ts.steps] == \
        [dataclasses.astuple(s) for s in rs.steps]
    return ts, rs


def _reference(rsched, x, name):
    """The simulator's outputs and stats, and the transport's counters
    of the same schedule run rank by rank in threads."""
    m = rmon.get(name)
    p = rsched.p
    with jax.enable_x64(True):
        with rsch.collect_stats() as st:
            want = rsch.SimulatorExecutor().execute(rsched, x, m)
        xs = [jax.tree.map(lambda a: np.asarray(a)[r], x) for r in range(p)]
        with LocalTransport(p, timeout=TIMEOUT) as tr:
            run_ranks_threaded(tr, rsched, xs, m)
            traffic = tr.stats()
    return want, st, traffic


def _root_traffic(sched, nbytes):
    """(messages, bytes) the transport sends for all-gathers (g−1
    payloads to the group root, g−1 lists of g back) and broadcasts (g−1
    payloads from the root) in every group of the step's axis, and the
    number of ``all_gather`` calls the pool makes for them (one a rank
    and step)."""
    msgs = nb = calls = 0
    for st in sched.steps:
        if st.kind not in ("allgather", "bcast"):
            continue
        sizes, j = tsch._axis_fold(sched, st.axis)
        g = sizes[j]
        groups = sched.p // g
        calls += sched.p
        if st.kind == "allgather":
            msgs += groups * 2 * (g - 1)
            nb += groups * (g - 1) * (g + 1) * nbytes
        else:
            msgs += groups * (g - 1)
            nb += groups * (g - 1) * nbytes
    return msgs, nb, calls


def _same(got, want, name):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if name in ("affine", "matmul"):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            assert np.array_equal(g, w)


def _check(pool, ts, rs, x, name, *, fused=True):
    """The pool against the simulator and the transport (module doc)."""
    want, rst, traffic = _reference(rs, x, name)
    res = pool.run(ts, x, monoid=name, fused=fused)
    _same(res.outputs, want, name)
    st = res.stats
    assert (st["rounds"], st["op_applications"], st["allgathers"],
            st["bytes_per_round"]) == (rst.rounds, rst.op_applications,
                                       rst.allgathers,
                                       list(rst.bytes_per_round))
    m = tmon.get(name)
    ir = (ts.kernel_launches(m.commutative, fused=fused),
          ts.kernel_passes(m.commutative, fused=fused)) \
        if se.supports(m) else (0, 0)  # matmul: torch.matmul, no kernel
    assert [(s["kernel_launches"], s["hbm_passes"])
            for s in res.rank_stats] == [ir] * pool.p
    assert res.launches == [{}] * pool.p  # the CPU runs the plain versions
    nbytes = sum(np.asarray(a)[0].nbytes for a in jax.tree.leaves(x))
    msgs, nb, calls = _root_traffic(ts, nbytes)
    tr = res.transport
    assert tr["msgs"] + msgs == traffic["local_msgs"]
    assert tr["bytes"] + nb == traffic["local_bytes"]
    one = tdev.to_torch(jax.tree.map(lambda a: np.asarray(a)[0], x), "cpu")
    assert tsch.expected_messages(ts, one) == (tr["msgs"], tr["bytes"])
    assert (tr["gathers"], tr["gather_bytes"]) == (calls, calls * nbytes)
    assert tr["staged_copies"] == 0
    return res


def _exclusive_ref(x):
    ref = np.zeros_like(x)
    ref[1:] = np.cumsum(x[:-1], axis=0)
    return ref


@pytest.mark.parametrize("alg", EXCLUSIVE)
def test_exclusive_algorithms(pool, alg):
    ts, rs = _plans(dict(kind="exclusive", algorithm=alg), pool.p, 64)
    x = _witness("add", pool.p, 8, seed=pool.p)
    for fused in (True, False):
        res = _check(pool, ts, rs, x, "add", fused=fused)
        assert np.array_equal(res.outputs, _exclusive_ref(x))


@pytest.mark.parametrize("kind", ("scan_total", "allreduce"))
def test_scan_total_and_allreduce(pool, kind):
    # non-power-of-two p runs the exscan + with_total or the inclusive
    # scan + broadcast; powers of two the fused and plain butterflies
    ts, rs = _plans(dict(kind=kind, monoid="add"), pool.p, 64)
    x = _witness("add", pool.p, 8, seed=pool.p + 1)
    res = _check(pool, ts, rs, x, "add")
    total = np.broadcast_to(x.sum(0), x.shape)
    if kind == "scan_total":
        assert np.array_equal(res.outputs[0], _exclusive_ref(x))
        assert np.array_equal(res.outputs[1], total)
    else:
        assert np.array_equal(res.outputs, total)


@pytest.mark.parametrize("name", ("add", "affine"))
def test_segmented_ring_ragged(pool, name):
    # S does not divide the 10 elements: the last segment is padded
    for S in (3, 4):
        ts, rs = _plans(dict(kind="exclusive", algorithm="ring",
                             segments=S, monoid=name), pool.p, S * 16)
        assert ts.n_segments == S
        _check(pool, ts, rs, _witness(name, pool.p, 10, seed=S), name)


NONCOMM = ([("affine", alg) for alg in EXCLUSIVE]
           + [("matmul", alg) for alg in ("123", "two_op", "native")]
           + [("affine", "butterfly")])


@pytest.mark.parametrize("name,alg", NONCOMM,
                         ids=["-".join(c) for c in NONCOMM])
def test_noncommutative(pool, name, alg):
    kind = "allreduce" if alg == "butterfly" else "exclusive"
    ts, rs = _plans(dict(kind=kind, algorithm=alg, monoid=name), pool.p, 64)
    _check(pool, ts, rs, _witness(name, pool.p, 8, seed=pool.p + 2), name)


MULTIAXIS = [("add", "exclusive", alg)
             for alg in ("123", "1doubling", "two_op", "native")] + [
    ("add", "scan_total", "auto"), ("affine", "exclusive", "auto"),
    ("add", "hierarchical", "auto")]


@pytest.mark.parametrize("name,kind,alg", MULTIAXIS,
                         ids=["-".join(c) for c in MULTIAXIS])
def test_multiaxis(pool, name, kind, alg):
    # ranks row-major over ("pod", "data"); a run over one axis talks
    # within its group, and all-gathers go over that axis' sub-group
    grid = GRIDS[pool.p]
    if kind == "hierarchical":
        ts, rs = _hier(*grid, nbytes=4096)
    else:
        ts, rs = _plans(dict(kind=kind, algorithm=alg, monoid=name,
                             axis_name=("pod", "data")), grid, 128)
    assert ts.p == pool.p
    x = _witness(name, pool.p, 16, seed=sum(grid))
    res = _check(pool, ts, rs, x, name)
    if name == "add" and kind != "scan_total":
        assert np.array_equal(res.outputs, _exclusive_ref(x))


def test_scan_entry_points_take_one_rank(pool):
    # scan and scan_with_total with an SPMDExecutor: each rank passes
    # its own payload, without rank dimensions, and gets its own result
    p = pool.p
    x = _witness("add", p, 6, seed=11)
    spec = tsa.ScanSpec(kind="exclusive", monoid="xor",
                        algorithm="1doubling")
    res = pool.scan(x, spec)
    ref = np.zeros_like(x)
    ref[1:] = np.bitwise_xor.accumulate(x[:-1], axis=0)
    assert np.array_equal(res.outputs, ref)
    pl = tsa.plan(spec, p, nbytes=x[0].nbytes)
    assert (res.stats["rounds"], res.stats["op_applications"]) == \
        (pl.rounds, pl.op_applications)
    x32 = x.astype(np.int32) % 1000
    grid = GRIDS[p]
    res = pool.scan(x32, tsa.ScanSpec(kind="exclusive", monoid="add",
                                      axis_name=("pod", "data")),
                    entry="scan_with_total",
                    mesh=(("pod", grid[0]), ("data", grid[1])))
    assert np.array_equal(res.outputs[0], _exclusive_ref(x32))
    assert np.array_equal(res.outputs[1],
                          np.broadcast_to(x32.sum(0), x32.shape))


def test_fused_scan_through_pool(pool):
    p = pool.p
    xs = [_witness("add", p, n, seed=20 + n) for n in (3, 5, 1)]
    specs = [tsa.ScanSpec(kind="exclusive", monoid="add")] * len(xs)
    res = pool.scan(xs, specs, entry="fused_scan")
    for got, x in zip(res.outputs, xs):
        assert np.array_equal(got, _exclusive_ref(x))
    fp = tsa.plan_fused(specs, p, [x[0].nbytes for x in xs])
    assert fp.fused and res.stats["rounds"] == fp.rounds
    assert res.stats["op_applications"] == fp.packed.op_applications


def test_run_plan_repeats_and_hop(pool):
    pl = tsa.plan(tsa.ScanSpec(kind="scan_total", monoid="add"), pool.p,
                  nbytes=64)
    x = _witness("add", pool.p, 8, seed=6)
    res = run_plan(pool, pl, x, repeats=3)
    assert isinstance(res.outputs, tuple) and len(res.outputs) == 2
    assert np.array_equal(res.outputs[0], _exclusive_ref(x))
    assert len(res.seconds) == 3 and all(s > 0 for s in res.seconds)
    assert [len(r) for r in res.rank_seconds] == [pool.p] * 3
    assert all(s > 0 for r in res.rank_seconds for s in r)
    assert pool.measure_hop(4096, repeats=3) > 0


def test_schedule_p_mismatch_raises(pool):
    sched = tsa.plan(tsa.ScanSpec(kind="exclusive"), pool.p + 1,
                     nbytes=64).schedule()
    with pytest.raises(ValueError, match="pool"):
        pool.run(sched, _witness("add", pool.p + 1, 4, seed=0))


def test_child_error_comes_back_with_context(pool):
    # every child fails to set up (an object array makes no tensor): the
    # pool raises rank 0's traceback and stays usable, replies drained
    bad = np.empty((pool.p, 2), dtype=object)
    sched = tsa.plan(tsa.ScanSpec(kind="exclusive"), pool.p,
                     nbytes=16).schedule()
    with pytest.raises(RuntimeError, match="rank 0 failed") as err:
        pool.run(sched, bad)
    assert "Traceback" in str(err.value)
    x = _witness("add", pool.p, 2, seed=7)
    assert np.array_equal(pool.run(sched, x).outputs, _exclusive_ref(x))


def test_dead_child_closes_the_pool():
    pl = WorkerPool(2, backend="gloo", device="cpu", timeout=30)
    procs = list(pl._procs)
    procs[1].kill()
    procs[1].join(10)
    sched = tsa.plan(tsa.ScanSpec(kind="exclusive"), 2, nbytes=8).schedule()
    with pytest.raises(RuntimeError, match="rank 1"):
        pl.run(sched, _witness("add", 2, 1, seed=0))
    assert not any(proc.is_alive() for proc in procs)
    with pytest.raises(RuntimeError, match="closed"):
        pl.run(sched, _witness("add", 2, 1, seed=0))


def test_p_intra_is_not_ported():
    # blocks of p_intra ranks a process run (tests/test_torch_blocks.py);
    # a block of fewer than one rank is refused, as the reference does
    for bad in (0, -1):
        with pytest.raises(ValueError, match="p_intra"):
            WorkerPool(2, p_intra=bad, backend="gloo", device="cpu")


def test_launcher_cli_smoke():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.dist.launcher", "--nprocs",
         "2", "--device", "cpu", "--m", "4096", "--smoke"],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bit-identical to StackedExecutor: True" in proc.stdout
    assert "backend gloo" in proc.stdout


_NO_PROCESS_LEFT = """
import os
from repro_torch.dist import WorkerPool

def children():
    me, left = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me:
            left.append(int(pid))
    return left

pool = WorkerPool(2, backend="gloo", device="cpu", timeout=30)
pids = [proc.pid for proc in pool._procs]
assert set(pids) < set(children()), (pids, children())
pool.close()
print("left", children())
"""


def test_closed_pool_leaves_no_process():
    # the children and the spawn method's resource tracker are reaped by
    # close(), not left to exit after their parent
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _NO_PROCESS_LEFT],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "left []" in proc.stdout, proc.stdout
