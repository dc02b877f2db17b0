"""Blocks of ranks in each process: ``WorkerPool(nprocs, p_intra=P)``.

Process k holds the P consecutive global ranks [k·P, (k+1)·P) as the
leading axis of its tensors (``SPMDExecutor(ranks_per_proc=P)``), on a
``torch.distributed`` gloo group on the CPU (``device="cpu"``: the round
kernels' plain versions).  Every case runs one schedule three ways:
through the pool, through the JAX package's ``SimulatorExecutor`` (under
``jax.enable_x64``) and through its message-passing ``run_ranks_threaded``
on a ``LocalTransport`` that counts a message as crossing when its two
ranks lie in different blocks (``src // P != dst // P``).  The pool must
give the simulator's outputs (integers bit for bit, float64 affine and
matmul within rtol 1e-10 and atol 1e-12), process 0 its stats (rounds,
⊕, all-gathers, ``bytes_per_round``), every process the IR's kernel
launches, and its crossing bytes must equal the transport's
``cross_bytes`` less what the transport sends through a group root for
all-gathers and broadcasts (the pool runs those as ``all_gather``), and
its messages ``schedule.expected_messages`` for the block layout.

Two pools serve the module, (2, 4) and (3, 4), 8 and 12 ranks (spawning
takes seconds); plans are made by both packages under the reference's
constants, so the IRs are the same.  The CLIs run last: the launcher's
``--p-intra`` smoke and the ported dist bench in subprocesses, and
``tune --dist 2 --dist-intra 2`` in-process (its own 2 × 2 pool).
"""

import dataclasses
import json
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
from repro.launch import mesh as r_mesh
from repro_torch import device as tdev
from repro_torch.benchmarks import dist_bench
from repro_torch.core import monoid as tmon
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.core import tune as t_tune
from repro_torch.dist import WorkerPool, run_plan
from repro_torch.kernels import scan_engine as se

POOLS = ((2, 4), (3, 4))  # (nprocs, p_intra)
TIMEOUT = 60
RTOL, ATOL = 1e-10, 1e-12
EXCLUSIVE = ("123", "1doubling", "two_op", "native", "ring", "halving",
             "quartering", "reduce_scatter")
# ("pod", "data") grids over each pool's ranks: the (proc, local) layout,
# and one whose inner groups span processes or halve a block
GRIDS = {(2, 4): ((2, 4), (4, 2)), (3, 4): ((3, 4), (2, 6))}
HIER = {(3, 4): 262_144, (2, 4): 1_048_576}  # the reference's dist configs
_R = rsa.DEFAULT_COST_MODEL
REF_COST = tsa.CostModel(alpha=_R.alpha, beta=_R.beta, gamma=_R.gamma)
REF_TIERS = tsa.CostProfile.from_json(r_mesh.DEFAULT_PROFILE.to_json())
ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


@pytest.fixture(scope="module", params=POOLS,
                ids=lambda c: f"{c[0]}x{c[1]}")
def pool(request):
    nprocs, P = request.param
    with WorkerPool(nprocs, p_intra=P, backend="gloo", device="cpu",
                    timeout=TIMEOUT) as pl:
        yield pl


class BlockTransport(LocalTransport):
    """Every rank in one process, each message counted as crossing when
    its ranks lie in different blocks of ``P``."""

    def __init__(self, p: int, P: int, **kw):
        super().__init__(p, **kw)
        self.P = P

    def send(self, src: int, dst: int, payload):
        nbytes = sum(np.asarray(a).nbytes for a in jax.tree.leaves(payload))
        self._count(nbytes, cross=src // self.P != dst // self.P)
        self._mail.put(src, dst, payload)


def _witness(name, p, n, seed):
    rng = np.random.default_rng(seed)
    if name == "affine":
        return (rng.standard_normal((p, n)), rng.standard_normal((p, n)))
    if name == "matmul":
        return rng.standard_normal((p, 3, 3)) * 0.5
    return rng.integers(0, 1 << 30, size=(p, n)).astype(np.int64)


def _same_steps(ts, rs):
    assert (ts.algorithm, ts.p, ts.axes) == (rs.algorithm, rs.p, rs.axes)
    assert [dataclasses.astuple(s) for s in ts.steps] == \
        [dataclasses.astuple(s) for s in rs.steps]


def _plans(spec_kw, ps, nbytes):
    """The port's and the reference's schedules of one spec; equal."""
    ts = tsa.plan(tsa.ScanSpec(**spec_kw), ps, nbytes=nbytes,
                  cost_model=REF_COST).schedule()
    rs = rsa.plan(rsa.ScanSpec(**spec_kw), ps, nbytes=nbytes).schedule()
    _same_steps(ts, rs)
    return ts, rs


def _hier(p_inter, p_intra, nbytes):
    """The reference's hierarchical plan under its default tiers (ici
    inside a process, dci across), and the port's under the same
    constants; equal."""
    spec = dict(kind="exclusive", monoid="add")
    tp = tsa.plan_hierarchical(tsa.ScanSpec(**spec), p_inter=p_inter,
                               p_intra=p_intra, nbytes=nbytes,
                               cost_model=REF_TIERS)
    rp = rsa.plan_hierarchical(rsa.ScanSpec(**spec), p_inter=p_inter,
                               p_intra=p_intra, nbytes=nbytes)
    _same_steps(tp.schedule(), rp.schedule())
    return tp, rp


def _reference(rsched, x, name, P):
    """The simulator's outputs and stats, and the block-counting
    transport's counters of the same schedule run rank by rank."""
    m = rmon.get(name)
    p = rsched.p
    with jax.enable_x64(True):
        with rsch.collect_stats() as st:
            want = rsch.SimulatorExecutor().execute(rsched, x, m)
        xs = [jax.tree.map(lambda a: np.asarray(a)[r], x) for r in range(p)]
        with BlockTransport(p, P, timeout=TIMEOUT) as tr:
            run_ranks_threaded(tr, rsched, xs, m)
            traffic = tr.stats()
    return want, st, traffic


def _root_cross(sched, nbytes, P):
    """(crossing bytes the transport sends for all-gathers, each non-root
    member's payload to the group root and the list of g back, and for
    broadcasts, the root's payload to each member; the pool's
    ``all_gather`` calls: one a step by each process whose ranks share a
    group with another process's)."""
    nb = calls = 0
    for st in sched.steps:
        if st.kind not in ("allgather", "bcast"):
            continue
        sizes, j = tsch._axis_fold(sched, st.axis)
        callers = set()
        for r in range(sched.p):
            g, q = tsch._axis_members(sizes, j, r)
            if q:
                continue
            procs = {i // P for i in g}
            if len(procs) > 1:
                callers |= procs
            root = g[0] if st.kind == "allgather" else g[st.root]
            for i in g:
                if i // P != root // P:
                    nb += nbytes * (1 + len(g)) if st.kind == "allgather" \
                        else nbytes
        calls += len(callers)
    return nb, calls


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
    P = pool.p_intra
    want, rst, traffic = _reference(rs, x, name, P)
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
            for s in res.rank_stats] == [ir] * pool.nprocs
    assert res.launches == [{}] * pool.nprocs  # the CPU's plain versions
    nbytes = sum(np.asarray(a)[0].nbytes for a in jax.tree.leaves(x))
    root_bytes, calls = _root_cross(ts, nbytes, P)
    tr = res.transport
    assert tr["bytes"] + root_bytes == traffic["cross_bytes"]
    one = tdev.to_torch(jax.tree.map(lambda a: np.asarray(a)[0], x), "cpu")
    assert tsch.expected_messages(ts, one, ranks_per_proc=P) == \
        (tr["msgs"], tr["bytes"])
    assert (tr["gathers"], tr["gather_bytes"]) == (calls,
                                                   calls * P * nbytes)
    assert tr["staged_copies"] == 0
    return res


def _exclusive_ref(x):
    ref = np.zeros_like(x)
    ref[1:] = np.cumsum(x[:-1], axis=0)
    return ref


def test_pool_reports_its_topology(pool):
    assert pool.p == pool.nprocs * pool.p_intra
    assert (pool.p_intra, pool.platform) == (4, "cpu")


@pytest.mark.parametrize("alg", EXCLUSIVE)
def test_exclusive_algorithms(pool, alg):
    # one axis over nprocs·P ranks: shifts by skip < P mix rows read in
    # place with rows from the previous process, skip >= P reach past it
    ts, rs = _plans(dict(kind="exclusive", algorithm=alg), pool.p, 64)
    x = _witness("add", pool.p, 8, seed=pool.p)
    for fused in (True, False):
        res = _check(pool, ts, rs, x, "add", fused=fused)
        assert np.array_equal(res.outputs, _exclusive_ref(x))
        tr = res.transport  # native gathers, the others send
        assert (tr["gathers"] if alg == "native" else tr["msgs"]) > 0


@pytest.mark.parametrize("kind", ("scan_total", "allreduce"))
def test_scan_total_and_allreduce(pool, kind):
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
    # S does not divide the 10 elements; each round the block's first row
    # receives from the previous process, the others in place
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


def test_reference_hierarchical(pool):
    # the reference's dist configs, priced at their size (halving inside
    # and a ring of S = 2 across at 3 x 4, halving inside and 123 across
    # at 2 x 4), run on a shrunken witness
    tp, rp = _hier(pool.nprocs, pool.p_intra, HIER[pool.nprocs,
                                                   pool.p_intra])
    inner, outer = tp.sub_plans[0], tp.sub_plans[-1]
    assert inner.algorithm != outer.algorithm
    S = max(sp.segments for sp in tp.sub_plans)
    x = _witness("add", tp.p, 4 * S, seed=1)
    res = _check(pool, tp.schedule(), rp.schedule(), x, "add")
    assert np.array_equal(res.outputs, _exclusive_ref(x))
    assert res.transport["bytes"] > 0


MULTIAXIS = [("add", "exclusive", alg)
             for alg in ("123", "1doubling", "two_op", "native")] + [
    ("add", "scan_total", "auto"), ("affine", "exclusive", "auto"),
    ("add", "hierarchical", "auto")]


@pytest.mark.parametrize("grid_i", (0, 1), ids=("blocks", "across"))
@pytest.mark.parametrize("name,kind,alg", MULTIAXIS,
                         ids=["-".join(c) for c in MULTIAXIS])
def test_multiaxis(pool, name, kind, alg, grid_i):
    # ranks row-major over ("pod", "data"): on the (nprocs, P) grid a run
    # over "data" stays in each block and one over "pod" crosses with P
    # groups a process; on the other grid groups straddle blocks
    grid = GRIDS[pool.nprocs, pool.p_intra][grid_i]
    if kind == "hierarchical":
        tp, rp = _hier(*grid, nbytes=4096)
        ts, rs = tp.schedule(), rp.schedule()
    else:
        ts, rs = _plans(dict(kind=kind, algorithm=alg, monoid=name,
                             axis_name=("pod", "data")), grid, 128)
    assert ts.p == pool.p
    x = _witness(name, pool.p, 16, seed=sum(grid))
    res = _check(pool, ts, rs, x, name)
    if name == "add" and kind != "scan_total":
        assert np.array_equal(res.outputs, _exclusive_ref(x))


def test_scan_entry_points_take_the_block(pool):
    # scan and scan_with_total with a block executor: each process passes
    # its block's payloads on one leading axis and gets its block back
    p, P = pool.p, pool.p_intra
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
    res = pool.scan(x32, tsa.ScanSpec(kind="exclusive", monoid="add",
                                      axis_name=("proc", "local")),
                    entry="scan_with_total",
                    mesh=(("proc", pool.nprocs), ("local", P)))
    assert np.array_equal(res.outputs[0], _exclusive_ref(x32))
    assert np.array_equal(res.outputs[1],
                          np.broadcast_to(x32.sum(0), x32.shape))
    hp = tsa.plan(tsa.ScanSpec(kind="scan_total", monoid="add",
                               axis_name=("proc", "local")),
                  (pool.nprocs, P), nbytes=x32[0].nbytes)
    assert res.stats["rounds"] == hp.rounds


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


def test_rank_seconds_are_the_processes(pool):
    pl = tsa.plan(tsa.ScanSpec(kind="exclusive", monoid="add",
                               algorithm="123"), pool.p, nbytes=64)
    x = _witness("add", pool.p, 8, seed=6)
    res = run_plan(pool, pl, x, repeats=3)
    assert np.array_equal(res.outputs, _exclusive_ref(x))
    P = pool.p_intra
    assert [len(r) for r in res.rank_seconds] == [pool.p] * 3
    for rep, secs in zip(res.rank_seconds, res.seconds):
        assert all(s > 0 for s in rep) and max(rep) == secs
        assert all(rep[k * P:(k + 1) * P] == [rep[k * P]] * P
                   for k in range(pool.nprocs))
    assert len(res.rank_stats) == len(res.launches) == \
        len(res.memory) == pool.nprocs
    assert pool.measure_hop(4096, repeats=3) > 0


def test_schedule_p_mismatch_raises(pool):
    sched = tsa.plan(tsa.ScanSpec(kind="exclusive"), pool.nprocs,
                     nbytes=64).schedule()
    with pytest.raises(ValueError, match="pool"):
        pool.run(sched, _witness("add", pool.nprocs, 4, seed=0))


@pytest.mark.parametrize("alg", ("123", "1doubling", "two_op"))
def test_expected_messages_by_block_size(alg):
    # a shift by s over 12 ranks: 12 − s sending ranks; in blocks of 4
    # the crossing rows are min(s, 4) a process boundary (s of them when
    # s < 4) and one message a process pair; one block sends nothing
    ts, _ = _plans(dict(kind="exclusive", algorithm=alg), 12, 64)
    one = tdev.to_torch(np.zeros(8, np.int64), "cpu")
    shifts = [st.skip for st in ts.steps if st.kind == "shift"]
    assert tsch.expected_messages(ts, one) == (
        sum(12 - s for s in shifts), 64 * sum(12 - s for s in shifts))
    rows = sum(sum(1 for r in range(12 - s) if r // 4 != (r + s) // 4)
               for s in shifts)
    links = sum(len({(r // 4, (r + s) // 4) for r in range(12 - s)
                     if r // 4 != (r + s) // 4}) for s in shifts)
    assert tsch.expected_messages(ts, one, ranks_per_proc=4) == \
        (links, 64 * rows)
    assert tsch.expected_messages(ts, one, ranks_per_proc=12) == (0, 0)


def test_reference_profile_is_the_jax_packages():
    assert dist_bench.REFERENCE_PROFILE.to_json() == \
        REF_TIERS.to_json()
    assert [dict(nprocs=c["nprocs"], p_intra=c["p_intra"],
                 nbytes=c["nbytes"]) for c in dist_bench.CONFIGS] == \
        [{"nprocs": 3, "p_intra": 4, "nbytes": 262_144},
         {"nprocs": 2, "p_intra": 4, "nbytes": 1_048_576}]


def _run(args, timeout=180):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m"] + args,
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=ROOT)


def test_launcher_cli_blocks_smoke():
    proc = _run(["repro_torch.dist.launcher", "--nprocs", "2", "--p-intra",
                 "2", "--device", "cpu", "--m", "4096", "--smoke"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 processes x 2 ranks" in proc.stdout
    assert "bit-identical to StackedExecutor: True" in proc.stdout
    assert "inter ('proc' tier)" in proc.stdout


def test_cli_dist_intra_writes_a_profile(tmp_path, capsys):
    rc = t_tune.main(["--dist", "2", "--dist-intra", "2", "--device", "cpu",
                      "--out", str(tmp_path)])
    assert rc == 0
    path = t_tune.profile_path("dist-cpu-procs2x2", str(tmp_path))
    assert os.path.exists(path)
    with open(path) as f:
        prof = tsa.CostProfile.from_json(json.load(f))
    assert prof.mesh_fingerprint == "dist-cpu-procs2x2"
    assert [n for n, _ in prof.tiers] == ["dci", "stacked"]
    assert f"wrote {path}" in capsys.readouterr().out


def test_dist_bench_check(tmp_path):
    out = tmp_path / "bench.json"
    proc = _run(["repro_torch.benchmarks.dist_bench", "--device", "cpu",
                 "--check", "--json", str(out)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = json.loads(out.read_text())["rows"]
    want = []
    for c in dist_bench.CONFIGS:  # the reference's per-tier picks
        rp = rsa.plan_hierarchical(
            rsa.ScanSpec(kind="exclusive", monoid="add"),
            p_inter=c["nprocs"], p_intra=c["p_intra"], nbytes=c["nbytes"])
        want.append((c["nprocs"], c["p_intra"], rp.sub_plans[0].algorithm,
                     rp.sub_plans[-1].algorithm, rp.rounds))
    assert [(r["nprocs"], r["p_intra"], r["intra_algorithm"],
             r["inter_algorithm"], r["rounds_dist"]) for r in rows] == want
    assert all(r["ok"] and r["cross_bytes"] > 0 for r in rows)
