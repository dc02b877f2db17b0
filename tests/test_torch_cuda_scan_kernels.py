"""The chunked-scan and routing kernels on the card: each instance
bit-identical to its plain PyTorch version, and the paths that run them
equal to their CPU runs (marked ``cuda``; skipped where there is no
card).  Also composed (multi-axis) scans on the card against their CPU
runs, and the calibration's walltime clock.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_scan_kernels.py
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import scan_api as sa
from repro_torch.core import schedule as sch
from repro_torch.core import tune
from repro_torch.kernels import moe_routing as mr
from repro_torch.kernels import scan_engine as se

pytestmark = pytest.mark.cuda

G, T, D = 3, 37, 4099  # ragged: no multiple of any tile or warp width
DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64,
          torch.bfloat16)
MONOID_CASES = [(op, dt) for op, dt in itertools.product(
    ("add", "mul", "max", "min", "xor"), DTYPES) if se.kernel_serves(op, dt)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _leaf(rng, dtype, shape, device):
    if dtype in (torch.int32, torch.int64):
        a = rng.integers(-(1 << 20), 1 << 20, size=shape)
    else:
        a = rng.uniform(0.9, 1.1, size=shape)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _same(got, want):
    return all((g is None and w is None) or
               (g.shape == w.shape and torch.equal(g, w))
               for g, w in zip(got, want))


# Both regimes of monoid_chunk: the look-back scan (an integer ⊕ at
# D = 1) over many 4096-element tiles with a ragged last one, one tile,
# T < one tile and T = 0; the strip stream at ragged D, a whole strip
# and T = 0.  The long D = 1 shapes take the integer cases only (the
# float ones run regime B there, whose plain version is a row loop).
REGIME_SHAPES = [(1, 100_003, 1), (3, 50_001, 1), (1, 4096, 1),
                 (2, 1000, 1), (2, 0, 1), (2, 4099, 37), (1, 300, 64),
                 (2, 0, 37)]
REGIME_CASES = [(shape, op, dt) for shape in REGIME_SHAPES
                for op, dt in MONOID_CASES
                if shape[1] <= 4096 or dt in (torch.int32, torch.int64)]


@pytest.mark.parametrize("op,dtype", MONOID_CASES, ids=lambda v: str(v))
def test_monoid_chunk_bit_identical_to_plain(card, op, dtype):
    _monoid_chunk_cases(card, op, dtype, (G, T, D))


@pytest.mark.parametrize("shape,op,dtype", REGIME_CASES,
                         ids=lambda v: str(v))
def test_monoid_chunk_regimes_bit_identical_to_plain(card, shape, op,
                                                     dtype):
    _monoid_chunk_cases(card, op, dtype, shape)


def _monoid_chunk_cases(card, op, dtype, shape):
    g, t, d = shape
    rng = np.random.default_rng(0)
    x = _leaf(rng, dtype, (g, t, d), card)
    init = _leaf(rng, dtype, (g, d), card)
    before = se.monoid_chunk.launches
    for kw in (dict(), dict(init=init, exclusive=False, final=True),
               dict(traj=False, final=True)):
        got = se.monoid_chunk(x, op, **kw)
        want = se.monoid_chunk_plain(x, op, **kw)
        torch.cuda.synchronize()
        assert _same(got, want), (kw, se.monoid_chunk_regime(op, dtype, d))
    assert se.monoid_chunk.launches - before == 3


def test_lookback_scan_is_the_same_in_every_run(card):
    """Regime A: 20 runs over 10⁶ int64 give one result, the plain one."""
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -(1 << 40), 1 << 40, (1, 10**6, 1))).to(card)
    want = se.monoid_chunk_plain(x, "add", final=True)
    for _ in range(20):
        got = se.monoid_chunk(x, "add", final=True)
        torch.cuda.synchronize()
        assert _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_affine_chunk_bit_identical_to_plain(card, dtype):
    rng = np.random.default_rng(1)
    a, b = (_leaf(rng, dtype, (G, T, D), card) for _ in range(2))
    a0, h0 = (_leaf(rng, dtype, (G, D), card) for _ in range(2))
    before = se.affine_chunk.launches
    cases = (dict(h0=h0, h_final=True), dict(h_traj=False, a_final=True,
                                             h_final=True),
             dict(a0=a0, h0=h0, exclusive=True, a_traj=True, a_final=True,
                  h_final=True))
    for kw in cases:
        got = se.affine_chunk(a, b, **kw)
        want = se.affine_chunk_plain(a, b, **kw)
        torch.cuda.synchronize()
        assert _same(got, want), kw
    assert se.affine_chunk.launches - before == len(cases)


def test_moe_routing_bit_identical_to_plain(card):
    rng = np.random.default_rng(2)
    for shape, E in (((1000, 3), 61), ((4, 300, 4), 64), ((2, 50, 8), 700)):
        ids = torch.from_numpy(rng.integers(0, E, shape).astype(np.int32))
        ids = ids.to(card)
        before = mr.moe_routing.launches
        got = mr.moe_routing(ids, num_experts=E)
        want = mr.moe_routing_plain(ids, num_experts=E)
        torch.cuda.synchronize()
        assert _same(got, want), (shape, E)
        assert mr.moe_routing.launches - before == 1


def test_wrappers_refuse_what_no_kernel_serves(card):
    x = torch.ones((4, 8), device=card)
    with pytest.raises(TypeError):
        se.monoid_chunk(x, "xor")
    with pytest.raises(TypeError):
        se.affine_chunk(x.to(torch.bfloat16), x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        se.monoid_chunk(x.t(), "add")


def test_cp_ssm_and_dispatch_on_card_match_cpu(card):
    from repro_torch import configs
    from repro_torch.models.context_parallel import cp_ssm_scan
    from repro_torch.models.moe import dispatch_slots

    rng = np.random.default_rng(3)
    p, bsz, seq, d = 8, 2, 32, 300
    a = torch.from_numpy(rng.uniform(0.8, 1.0, (p, bsz, seq, d))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((p, bsz, seq, d))
                         .astype(np.float32))
    got = cp_ssm_scan(a.to(card), b.to(card), algorithm="123")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cp_ssm_scan(a, b, algorithm="123"))

    cfg = configs.get("qwen2-moe-a2.7b")
    keys = rng.random((p, 128, cfg.n_experts))
    top_e = torch.from_numpy(np.argsort(keys, -1)[..., :cfg.top_k]
                             .astype(np.int32))
    for g, w in zip(dispatch_slots(cfg, top_e.to(card)),
                    dispatch_slots(cfg, top_e)):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# MoE routing: one thread-block cluster per group
# ---------------------------------------------------------------------------


def _route_same(ids, E, cluster=None):
    """One launch, bit for bit against the plain version."""
    before = mr.moe_routing.launches
    got = mr.moe_routing(ids, num_experts=E, _cluster=cluster)
    want = mr.moe_routing_plain(ids, num_experts=E)
    torch.cuda.synchronize()
    assert mr.moe_routing.launches - before == 1
    assert _same(got, want), (tuple(ids.shape), E, cluster)
    return got


def _ids(rng, shape, E, lo=0, hi=None):
    a = rng.integers(lo, E if hi is None else hi, shape).astype(np.int32)
    return torch.from_numpy(a).cuda()


# per cluster size: chunk bounds exactly on, one before and one past a
# multiple of 4·CL; fewer entries than 4·CL (empty chunks); T = 0
EDGE_SHAPES = [(2, 64, 4), (2, 63, 4), (2, 65, 4), (3, 7, 1), (2, 1, 3),
               (2, 0, 4), (1, 4097, 3)]


@pytest.mark.parametrize("cluster", mr.CLUSTER_SIZES)
def test_moe_routing_cluster_edges_bit_identical(card, cluster):
    rng = np.random.default_rng(20 + cluster)
    for shape in EDGE_SHAPES:
        _route_same(_ids(rng, shape, 61), 61, cluster)


def test_moe_routing_one_group_largest_cluster(card):
    rng = np.random.default_rng(21)
    for shape in ((1, 4096, 4), (1, 100_003, 3)):
        ids = _ids(rng, shape, 64)
        _route_same(ids, 64, max(mr.CLUSTER_SIZES))
        _route_same(ids, 64)


def test_moe_routing_one_expert_everywhere(card):
    for cluster in (None, 1, 8):
        ids = torch.full((4, 4096, 4), 5, dtype=torch.int32, device=card)
        pos, counts = _route_same(ids, 64, cluster)
        assert int(counts[:, 5].min()) == 4096 * 4


def test_moe_routing_ids_outside_the_experts(card):
    rng = np.random.default_rng(22)
    for cluster in (None, 1, 4, 8):
        ids = _ids(rng, (3, 1001, 4), 40, lo=-3, hi=45)
        _route_same(ids, 40, cluster)


def test_moe_routing_700_experts(card):
    rng = np.random.default_rng(23)
    for shape in ((2, 50, 8), (64, 4096, 4), (1, 4096, 4)):
        _route_same(_ids(rng, shape, 700), 700)


def test_moe_routing_large_expert_counts_in_turn(card):
    """Tables past 48 KB at two E of one kernel instance, each after the
    other: the card's one-time set-up for one E serves the next."""
    rng = np.random.default_rng(26)
    for E in (3000, 1500, 3000, 1500):
        for cluster in (None, 1, 2):
            _route_same(_ids(rng, (2, 300, 4), E), E, cluster)


def test_moe_routing_sets_the_card_up_once(card):
    rng = np.random.default_rng(27)
    ids = _ids(rng, (3, 999, 2), 64)
    _route_same(ids, 64)
    before = mr._setup.cache_info()
    for _ in range(3):
        _route_same(ids, 64)
    after = mr._setup.cache_info()
    assert (after.misses, after.hits) == (before.misses, before.hits + 3)


def test_moe_routing_unaligned_group_bases(card):
    """Odd T·K puts every other group's base off 16 bytes; a view one
    int32 into its storage puts every base there."""
    rng = np.random.default_rng(24)
    for cluster in (None, 1, 2, 8):
        _route_same(_ids(rng, (5, 333, 3), 64), 64, cluster)
        flat = _ids(rng, (1 + 4 * 2048 * 4,), 64)
        _route_same(flat[1:].view(4, 2048, 4), 64, cluster)


def test_moe_routing_repeats_identical(card):
    """20 runs at moe_dispatch's shape, each after a call at another
    shape, give one result, the plain one."""
    rng = np.random.default_rng(25)
    ids = _ids(rng, (64, 4096, 4), 64)
    want = mr.moe_routing_plain(ids, num_experts=64)
    others = [_ids(rng, s, 64) for s in ((1, 4096, 4), (64, 64, 4),
                                         (3, 999, 2))]
    for i in range(20):
        mr.moe_routing(others[i % len(others)], num_experts=64)
        got = mr.moe_routing(ids, num_experts=64)
        torch.cuda.synchronize()
        assert _same(got, want), i


def test_moe_routing_refuses_what_it_cannot_hold(card):
    ids = torch.zeros((2, 8, 2), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError):
        mr.moe_routing(ids, num_experts=100_000)
    with pytest.raises(ValueError):
        mr.moe_routing(ids, num_experts=8, _cluster=3)


@pytest.mark.parametrize("case", ("hier_xor", "pod_data_total",
                                  "affine_3axis", "ring_inner"))
def test_composed_scan_on_card_equals_cpu(card, case):
    rng = np.random.default_rng(7)
    cost = None
    if case == "affine_3axis":
        grid, axes = (2, 3, 4), ("x", "y", "z")
        x = tuple(torch.from_numpy(rng.uniform(0.9, 1.1, grid + (37,)))
                  .to(torch.float32) for _ in range(2))
        spec = sa.ScanSpec(monoid="affine", axis_name=axes)
    else:
        grid = (3, 8) if case != "ring_inner" else (2, 12)
        n = 37 if case != "ring_inner" else (2 << 20) // 8 + 3
        x = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40,
                                          grid + (n,)))
        spec = sa.ScanSpec(monoid="xor", axis_name=("proc", "local"))
        if case == "pod_data_total":
            spec = sa.ScanSpec(kind="scan_total", monoid="add",
                               axis_name=("pod", "data"))
        if case == "ring_inner":  # the JAX package's default constants
            cost = sa.CostModel(alpha=1e-6, beta=1.0 / 50e9,
                                gamma=2.0 / 819e9)
            pl = sa.plan(spec, grid, nbytes=8 * n, cost_model=cost)
            assert pl.sub_plans[0].algorithm == "ring"
            assert pl.sub_plans[0].segments > 1
    want = sa.scan(x, spec, cost_model=cost,
                   executor=sch.StackedExecutor("cpu"))
    on_card = tuple(t.to(card) for t in x) if isinstance(x, tuple) \
        else x.to(card)
    got = sa.scan(on_card, spec, cost_model=cost)
    for g, w in zip(_flat(got), _flat(want)):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)


def _flat(t):
    return [u for part in t for u in _flat(part)] \
        if isinstance(t, tuple) else [t]


def test_walltime_clock_times_a_schedule_on_the_card(card):
    sched = sa.get_algorithm("exclusive", "123").schedule(64)
    with sch.collect_stats() as st:
        secs = tune.measure_schedule_walltime(sched, 8000, repeats=3)
    assert 0 < secs < 1.0
    assert st.rounds == 4 * sched.rounds  # the warm-up and 3 timed runs
    fp = tune.local_device_fingerprint()
    assert fp.startswith("cuda-")
    assert fp.endswith(f"-n{torch.cuda.device_count()}")
