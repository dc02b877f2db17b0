"""Training through the context-parallel scans on the card (marked
``cuda``; skipped where there is no card): the cp scans' backward (two
``affine_chunk_bwd`` launches around the forward plan's affine round
kernels over the reversed ranks) against the sequential
``AffineChunkFn`` gradient on the card at ragged shard lengths; remat
policy "dots" against "nothing" on the card; ``sparse_gradient_sync``
on the card against its CPU run.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_cp_train.py
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import _tree
from repro_torch import configs
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels import scan_engine as se
from repro_torch.models import context_parallel as tcp
from repro_torch.models.model import DOTS, Model
from repro_torch.optim import init_error_feedback, sparse_gradient_sync

pytestmark = pytest.mark.cuda

# the split scan adds the sequential scan's terms in another order: the
# JAX package's cp tolerance (tests/test_context_parallel.py)
SCAN_TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, atol, rtol):
    scale = float(want.abs().max())
    d = (got - want).abs()
    assert bool((d <= atol * scale + rtol * want.abs()).all()), \
        float(d.max()) / max(scale, 1e-30)


def _inputs(card, kind, p, T, seed):
    """(x, y, gY) of (p, 1, T, ...): ssm with 4099 state columns, wkv
    with two heads of 64 (the decay broadcast over r = 64)."""
    g = torch.Generator(device=card).manual_seed(seed)
    if kind == "ssm":
        xs, ys = (p, 1, T, 4099), (p, 1, T, 4099)
    else:
        xs, ys = (p, 1, T, 2, 64, 1), (p, 1, T, 2, 64, 64)
    x = torch.rand(xs, generator=g, device=card) * 0.2 + 0.8
    y = torch.randn(ys, generator=g, device=card)
    gy = torch.randn(ys, generator=g, device=card)
    return x, y, gy


@pytest.mark.parametrize("algo", ["auto", "123", "two_op"])
@pytest.mark.parametrize("T", [37, 1])
@pytest.mark.parametrize("p", [3, 8])
@pytest.mark.parametrize("kind", ["ssm", "wkv"])
def test_cp_backward_matches_sequential(card, kind, p, T, algo):
    x, y, gy = _inputs(card, kind, p, T, seed=p * 100 + T)
    fn = tcp.cp_ssm_scan if kind == "ssm" else tcp.cp_wkv_scan
    xs, ys = x.clone().requires_grad_(), y.clone().requires_grad_()
    out = fn(xs, ys, algorithm=algo)
    before = se.launch_counts()
    with tsch.collect_stats() as st:
        got = torch.autograd.grad(out, [xs, ys], gy)
    torch.cuda.synchronize()
    moved = {k: v - before.get(k, 0) for k, v in se.launch_counts().items()}
    width = y[0, 0, 0].numel()
    pl = tsa.plan(tcp._carry_spec(None, algo), p, nbytes=2 * width * 4)
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    assert moved["affine_chunk_bwd"] == 2 and moved["affine_chunk"] == 0
    assert sum(moved[k] for k in ("combine", "exchange", "scan_reduce")) \
        == pl.schedule().kernel_launches(False, fused=True)
    xa = x.reshape(1, p * T, -1).clone().requires_grad_()
    ya = y.reshape(1, p * T, -1).clone().requires_grad_()
    h, _ = se.affine_chunk_h(xa, ya, torch.zeros((1, ya.shape[-1]),
                                                 device=card),
                             exclusive=kind == "wkv", final=False)
    want = torch.autograd.grad(h, [xa, ya], gy.reshape(h.shape))
    for g, w in zip(got, want):
        _close(g.reshape(w.shape), w, SCAN_TOL, SCAN_TOL)


class _CountDots(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in DOTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,ranks", [("rwkv6_1_6b", (1, 4)),
                                        ("qwen2_moe_a2_7b", (2, 4))])
def test_remat_dots_against_nothing(card, name, ranks):
    """fsdp_sp, fp32: "dots" gives "nothing"'s loss and gradients
    (within 1e-6 of scale / 1e-5) and runs fewer matrix products in the
    backward."""
    out = []
    batch = {k: torch.from_numpy(v).to(card) for k, v in synthetic_batch(
        configs.get_smoke(name), 2, 32, 0).items()}
    for policy in ("dots", "nothing"):
        cfg = configs.get_smoke(name, sharding_strategy="fsdp_sp",
                                remat_policy=policy)
        model = Model(cfg, ranks, device=card)
        params = model.init_params(0, trainable=True)
        loss, _ = model.loss(params, batch)
        with _CountDots() as count:
            grads = torch.autograd.grad(loss, _tree.leaves(params))
        out.append((loss.detach(), grads, count.n))
    (l1, g1, n1), (l2, g2, n2) = out
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=0)
    for a, b in zip(g1, g2):
        _close(a, b, 1e-6, 1e-5)
    assert n1 < n2, (n1, n2)


@pytest.mark.parametrize("k_fraction", [1.0, 0.1, 0.01])
def test_sparse_sync_matches_cpu(card, k_fraction):
    """The picks, the error feedback and the offsets equal the CPU's;
    the synced mean within the rounding of a sum of p entries (the
    card's ``index_add_`` adds in any order)."""
    p = 4
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((p, 300, 17)).astype(np.float32),
            "b": rng.standard_normal((p, 1000)).astype(np.float32)}
    err = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
           for k, v in tree.items()}
    runs = []
    for dev in ("cpu", card):
        runs.append(sparse_gradient_sync(
            {k: torch.from_numpy(v).to(dev) for k, v in tree.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in err.items()},
            k_fraction=k_fraction))
    (s_cpu, e_cpu, o_cpu), (s_card, e_card, o_card) = runs
    for k in tree:
        assert torch.equal(e_card[k].cpu(), e_cpu[k])
        scale = float(np.abs(tree[k] + err[k]).max())
        torch.testing.assert_close(s_card[k].cpu(), s_cpu[k], rtol=1e-6,
                                   atol=1e-6 * scale)
    assert torch.equal(o_card["compact_offsets"].cpu(),
                       o_cpu["compact_offsets"])
