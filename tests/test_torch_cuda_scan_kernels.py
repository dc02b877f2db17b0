"""The chunked-scan and routing kernels on the card: each instance
bit-identical to its plain PyTorch version, and the paths that run them
equal to their CPU runs (marked ``cuda``; skipped where there is no
card).

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_scan_kernels.py
"""

import itertools

import numpy as np
import pytest
import torch

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
