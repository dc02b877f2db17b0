"""Round kernels on the card: each instance bit-identical to its plain
PyTorch version (marked ``cuda``; skipped where there is no card).

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import scan_engine as se

pytestmark = pytest.mark.cuda

P, N = 37, 4099  # ragged: no multiple of any tile or warp width
OPS = ("add", "mul", "max", "min", "xor", "affine")
DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64,
          torch.bfloat16)
CASES = [(op, dt) for op, dt in itertools.product(OPS, DTYPES)
         if se.kernel_serves(op, dt)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _leaf(rng, dtype, rows, device, n=N):
    if dtype in (torch.int32, torch.int64):
        a = rng.integers(-(1 << 20), 1 << 20, size=(rows, n))
        return torch.from_numpy(a).to(device=device, dtype=dtype)
    a = rng.standard_normal((rows, n))
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _operand(rng, op, dtype, device, rows=P, n=N):
    if op == "affine":
        return (_leaf(rng, dtype, rows, device, n),
                _leaf(rng, dtype, rows, device, n))
    return _leaf(rng, dtype, rows, device, n)


def _same(x, y):
    xs = x if isinstance(x, tuple) else (x,)
    ys = y if isinstance(y, tuple) else (y,)
    return all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(xs, ys))


@pytest.mark.parametrize("op,dtype", CASES, ids=lambda v: str(v))
def test_round_kernels_bit_identical_to_plain(card, op, dtype):
    rng = np.random.default_rng(0)
    a, b, c = (_operand(rng, op, dtype, card) for _ in range(3))
    row = _operand(rng, op, dtype, card, rows=1)
    mask = torch.from_numpy(rng.integers(0, 2, size=P).astype(np.int32)).to(card)
    before = se.launch_counts()
    assert _same(se.combine(op, a, b), se.combine_plain(op, a, b))
    for else_a in (False, True):
        assert _same(se.combine(op, a, b, mask=mask, else_a=else_a),
                     se.combine_plain(op, a, b, mask=mask, else_a=else_a))
    # a broadcast operand (zero rank stride), as the native fold uses
    assert _same(se.combine(op, a, row, mask=mask, else_a=True),
                 se.combine_plain(op, a, row, mask=mask, else_a=True))
    assert _same(se.exchange(op, a, b, mask), se.exchange_plain(op, a, b, mask))
    for comm in (False, True):
        got = se.scan_reduce(op, a, b, c, mask, commutative=comm)
        want = se.scan_reduce_plain(op, a, b, c, mask, commutative=comm)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    torch.cuda.synchronize()
    after = se.launch_counts()
    assert after["combine"] - before["combine"] == 4
    assert after["exchange"] - before["exchange"] == 1
    assert after["scan_reduce"] - before["scan_reduce"] == 2


def _tables(p, device):
    """Row tables as the executor builds them: shifts by 1 and 5 (any
    negative entry reads zeros), an xor permutation (partners past p
    read zeros), and every row −1."""
    r = np.arange(p)
    tabs = {"shift1": r - 1, "shift5": r - 5,
            "xor4": np.where((r ^ 4) < p, r ^ 4, -1),
            "none": np.full(p, -1)}
    return {k: torch.from_numpy(v.astype(np.int32)).to(device)
            for k, v in tabs.items()}


# n = 4104: every row 16-byte aligned at each dtype (the vector path);
# n = 4099: rows alternate, so the scalar path and the tail run too.
@pytest.mark.parametrize("n", [4104, 4099])
@pytest.mark.parametrize("op,dtype", CASES, ids=lambda v: str(v))
def test_round_kernels_read_rows_in_place(card, op, dtype, n):
    """A row-table operand equals the plain version on the gathered
    rows, bit for bit, in every operand position."""
    rng = np.random.default_rng(1)
    a, b, c = (_operand(rng, op, dtype, card, n=n) for _ in range(3))
    mask = torch.from_numpy(rng.integers(0, 2, size=P).astype(np.int32)).to(card)
    before = se.launch_counts()
    for name, src in _tables(P, card).items():
        ra = se.Rows(a, src)
        ga = se.gather_rows(ra)
        pairs = [(se.combine(op, ra, b), se.combine_plain(op, ga, b)),
                 (se.combine(op, b, ra), se.combine_plain(op, b, ga))]
        for else_a in (False, True):
            pairs.append((se.combine(op, ra, b, mask=mask, else_a=else_a),
                          se.combine_plain(op, ga, b, mask=mask,
                                           else_a=else_a)))
        pairs.append((se.exchange(op, ra, b, mask),
                      se.exchange_plain(op, ga, b, mask)))
        for comm in (False, True):
            got = se.scan_reduce(op, ra, b, c, mask, commutative=comm)
            want = se.scan_reduce_plain(op, ga, b, c, mask, commutative=comm)
            pairs += list(zip(got, want))
        torch.cuda.synchronize()
        for k, (got, want) in enumerate(pairs):
            assert _same(got, want), (name, k)
    after = se.launch_counts()
    assert after["combine"] - before["combine"] == 4 * 4
    assert after["exchange"] - before["exchange"] == 4
    assert after["scan_reduce"] - before["scan_reduce"] == 4 * 2


def test_cuda_wrappers_refuse_what_no_kernel_serves(card):
    x = torch.ones((4, 8), device=card, dtype=torch.float32)
    with pytest.raises(TypeError):
        se.combine("xor", x, x)
    with pytest.raises(ValueError):
        se.combine("add", x, x, mask=torch.ones(4, device=card))


def _executor_payload(name, p, rng, device):
    if name == "affine":
        return tuple(torch.from_numpy(rng.standard_normal((p, 7)))
                     .to(device=device, dtype=torch.float32)
                     for _ in range(2))
    return torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, (p, 3, 5))) \
        .to(device)


@pytest.mark.parametrize("fused", [True, False])
def test_stacked_executor_on_card_matches_cpu(card, fused):
    """Every algorithm on the card equals the CPU's plain run, and the
    wrappers launch exactly the IR's kernel_launches."""
    from repro_torch import _tree
    from repro_torch.core import monoid, scan_api, schedule

    for kind in scan_api.KINDS:
        for algo in scan_api.algorithms(kind):
            for name in ("xor", "add", "affine"):
                m = monoid.get(name)
                for p in (2, 5, 8, 13):
                    for S in ((1, 4) if algo == "ring" else (1,)):
                        sched = scan_api.get_algorithm(kind, algo) \
                            .schedule(p, S)
                        rng = np.random.default_rng(p)
                        x = _executor_payload(name, p, rng, card)
                        x_cpu = _tree.tree_map(lambda t: t.cpu(), x)
                        want = schedule.StackedExecutor(
                            "cpu", fused=fused).execute(sched, x_cpu, m)
                        before = sum(se.launch_counts().values())
                        got = schedule.StackedExecutor(
                            card, fused=fused).execute(sched, x, m)
                        torch.cuda.synchronize()
                        delta = sum(se.launch_counts().values()) - before
                        assert delta == sched.kernel_launches(
                            m.commutative, fused=fused), (kind, algo, p)
                        for g, w in zip(_tree.leaves(got),
                                        _tree.leaves(want)):
                            assert torch.equal(g.cpu(), w), (kind, algo,
                                                             name, p, S)
