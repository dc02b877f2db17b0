"""The training path's kernel on the card (marked ``cuda``; skipped where
there is no card): ``affine_chunk_bwd`` bit-identical to its plain
version (its plain version adds da's r columns in the kernel's order),
the same in every run, ``gradcheck`` through ``AffineChunkFn`` in fp64,
and one smoke train step on the card against the same step on the CPU.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_train.py
"""

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch import configs
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels import scan_engine as se
from repro_torch.launch.steps import make_train_step
from repro_torch.models import params as tparams
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import Model
from repro_torch.optim import adamw_init

pytestmark = pytest.mark.cuda

# fp32 models, card against CPU: the JAX package's cross-mesh tolerance
# (tests/test_models.py) for the loss
ATOL, RTOL = 3e-4, 3e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(card, G, T, D, r, dtype, seed, exclusive, with_h0):
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.rand((G, T, D // r), generator=g, device=card,
                   dtype=dtype) * 0.2 + 0.8
    b = torch.randn((G, T, D), generator=g, device=card, dtype=dtype)
    h0 = torch.randn((G, D), generator=g, device=card, dtype=dtype) \
        if with_h0 else None
    _, h, _, _ = se.affine_chunk(a, b, h0=h0, exclusive=exclusive)
    gY = torch.randn((G, T, D), generator=g, device=card, dtype=dtype)
    gH = torch.randn((G, D), generator=g, device=card, dtype=dtype)
    return a, h, h0, gY, gH


SHAPES = [(3, 37, 4099, 1), (2, 33, 8192, 64), (2, 9, 96, 4),
          (3, 5, 36, 4), (1, 1, 64, 32), (5, 3, 64, 64), (1, 1, 1, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_affine_bwd_bit_identical(card, shape, dtype, exclusive, with_h0):
    G, T, D, r = shape
    a, h, h0, gY, gH = _operands(card, G, T, D, r, dtype, D + T, exclusive,
                                 with_h0)
    for gy, gh in ((gY, gH), (gY, None), (None, gH)):
        before = se.affine_chunk_bwd.launches
        got = se.affine_chunk_bwd(a, gy, gh, h, h0=h0, exclusive=exclusive)
        assert se.affine_chunk_bwd.launches == before + 1
        want = se.affine_chunk_bwd_plain(a, gy, gh, h, h0=h0,
                                         exclusive=exclusive)
        torch.cuda.synchronize()
        for name, x, y in zip(("da", "db", "dh0"), got, want):
            assert x.shape == y.shape and x.dtype == y.dtype, name
            assert torch.equal(x, y), (name, float((x - y).abs().max()))


def test_affine_bwd_repeats_bit_for_bit(card):
    a, h, h0, gY, gH = _operands(card, 4, 64, 32768, 64, torch.float32, 1,
                                 True, True)
    first = se.affine_chunk_bwd(a, gY, gH, h, h0=h0, exclusive=True)
    for _ in range(10):
        se.affine_chunk_bwd(a[:1], gY[:1], gH[:1], h[:1], h0=h0[:1],
                            exclusive=True)  # another shape in between
        again = se.affine_chunk_bwd(a, gY, gH, h, h0=h0, exclusive=True)
        for x, y in zip(first, again):
            assert torch.equal(x, y)


def test_unsupported_broadcast_raises(card):
    for r in (3, 128):
        a, h, h0, gY, gH = _operands(card, 1, 4, 3 * 128, r, torch.float32,
                                     2, False, False)
        with pytest.raises(TypeError, match=f"r = {r}"):
            se.affine_chunk_bwd(a, gY, gH, h, exclusive=False)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("r", [1, 32, 64])
def test_gradcheck_on_card(card, r, exclusive):
    g = torch.Generator(device=card).manual_seed(r)
    G, T, D = 2, 4, max(r, 4) * 2
    kw = dict(generator=g, device=card, dtype=torch.float64)
    args = [torch.rand((G, T, D // r), **kw).requires_grad_(),
            torch.randn((G, T, D), **kw).requires_grad_(),
            torch.randn((G, D), **kw).requires_grad_()]
    before = se.affine_chunk_bwd.launches
    assert torch.autograd.gradcheck(
        lambda a, b, h0: se.affine_chunk_h(a, b, h0, exclusive=exclusive),
        args)
    assert se.affine_chunk_bwd.launches > before


def test_wkv_backward_launches_the_kernel(card):
    """The wkv scan's backward on the card is one ``affine_chunk_bwd``
    launch, and agrees with the same backward on the CPU."""
    rng = np.random.default_rng(3)
    B, S, H, hd = 2, 40, 2, 64
    w = rng.uniform(0.8, 1.0, (B, S, H, hd, 1)).astype(np.float32)
    kv = (rng.standard_normal((B, S, H, hd, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    cot = rng.standard_normal((B, S, H, hd, hd)).astype(np.float32)
    grads = []
    for dev in (card, torch.device("cpu")):
        ts = [torch.from_numpy(x).to(dev).requires_grad_()
              for x in (w, kv, s0)]
        before = se.affine_chunk_bwd.launches
        s_prev, _ = trwkv.wkv_scan_chunked(*ts)
        grads.append([g.cpu() for g in torch.autograd.grad(
            s_prev, ts, torch.from_numpy(cot).to(dev))])
        assert se.affine_chunk_bwd.launches - before == (dev.type == "cuda")
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name,ranks", [("rwkv6_1_6b", (1, 1)),
                                        ("jamba_1_5_large_398b", (1, 1)),
                                        ("qwen2_moe_a2_7b", (2, 4))])
def test_smoke_train_step_card_against_cpu(card, name, ranks):
    """One step from the same weights and batch: the loss at the
    forward's tolerance.  A first AdamW step moves an entry by
    lr·(g/(|g| + 1e-8) + 0.1·p): about ±lr, but by less, and as the
    gradient's rounding says, where |g| is near that rounding.  So all
    but 1 in 1000 entries within 1e-3·lr of the CPU's, and none further
    than 2.2·lr, the most two such steps can differ by."""
    cfg = configs.get_smoke(name)
    batch = synthetic_batch(cfg, 2, 32, 0)
    host = tparams.init_params(cfg, 0, "cpu")
    out = []
    for dev in (torch.device("cpu"), card):
        model = Model(cfg, ranks, device=dev)
        params = model.load_params(_tree.tree_map(
            lambda t: t.detach().to(dev, copy=True), host), trainable=True)
        step = make_train_step(cfg, ranks, lr_peak=1e-3, warmup=1,
                               total_steps=10, model=model)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, _, m = step(params, adamw_init(params), tb, 1)
        out.append((float(m["loss"]), [p.detach().cpu() for p in
                                       _tree.leaves(params)]))
    (l_cpu, p_cpu), (l_card, p_card) = out
    np.testing.assert_allclose(l_card, l_cpu, atol=ATOL, rtol=RTOL)
    off = total = 0
    for x, y in zip(p_card, p_cpu):
        d = (x - y).abs() / 1e-3  # in units of the learning rate
        assert float(d.max()) <= 2.2
        off, total = off + int((d > 1e-3).sum()), total + d.numel()
    assert off <= 1e-3 * total, (off, total)
