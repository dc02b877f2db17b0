"""The model stack's kernels on the card (marked ``cuda``; skipped
where there is no card): ``affine_chunk`` with a broadcast decay
bit-identical to its plain version and to the materialised decay, the
wkv scan and ``cp_wkv_scan`` against their CPU runs, and the smoke
models on the card against the same models on the CPU.

Run on the machine with the card:
    python -m pytest -q -m cuda tests/test_torch_cuda_models.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import scan_engine as se
from repro_torch.launch.serve import serve_loop
from repro_torch.models import context_parallel as tcp
from repro_torch.models import params as tparams
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import Model

pytestmark = pytest.mark.cuda

# fp32 models, card against CPU: the JAX package's cross-mesh tolerance
# (tests/test_models.py); the scans sum in another order than one pass
ATOL, RTOL = 3e-4, 3e-3
SCAN_TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("r", [1, 2, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exclusive", [False, True])
def test_broadcast_affine_chunk_bit_identical(card, r, dtype, exclusive):
    g = torch.Generator(device=card).manual_seed(r)
    G, T, Da = 3, 37, 411
    a = torch.rand((G, T, Da), generator=g, device=card, dtype=dtype) \
        * 0.2 + 0.9
    b = torch.randn((G, T, Da * r), generator=g, device=card, dtype=dtype)
    a0 = torch.rand((G, Da), generator=g, device=card, dtype=dtype) + 0.5
    h0 = torch.randn((G, Da * r), generator=g, device=card, dtype=dtype)
    for kw in ({"h0": h0, "h_final": True},
               {"h_traj": False, "a_final": True, "h_final": True},
               {"a0": a0, "h0": h0, "a_traj": True, "a_final": True,
                "h_final": True}):
        kw = {**kw, "exclusive": exclusive}
        before = se.affine_chunk.launches
        got = se.affine_chunk(a, b, **kw)
        assert se.affine_chunk.launches == before + 1
        want = se.affine_chunk_plain(a, b, **kw)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert (x is None) == (y is None)
            assert x is None or torch.equal(x, y)
        full = se.affine_chunk(
            a.repeat_interleave(r, 2), b,
            **{**kw, "a0": a0.repeat_interleave(r, 1) if "a0" in kw
               else None})
        for x, y in zip(got[1::2], full[1::2]):
            assert x is None or torch.equal(x, y)


def test_broadcast_rejects_what_the_kernel_does_not_take(card):
    a = torch.ones((2, 4, 3), device=card)
    for b in (torch.ones((2, 4, 10), device=card),  # 3 does not divide 10
              torch.ones((2, 5, 6), device=card),  # other T
              torch.ones((2, 4, 6), device=card, dtype=torch.float64)):
        with pytest.raises(ValueError):
            se.affine_chunk(a, b)
    with pytest.raises(TypeError):
        se.affine_chunk(a.bfloat16(), torch.ones((2, 4, 6), device=card,
                                                 dtype=torch.bfloat16))


def test_wkv_scans_match_cpu(card):
    rng = np.random.default_rng(0)
    B, S, H, hd = 2, 96, 4, 64
    w = rng.uniform(0.8, 1.0, (B, S, H, hd, 1)).astype(np.float32)
    kv = (rng.standard_normal((B, S, H, hd, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (w, kv, s0)]
    want = trwkv.wkv_scan_chunked(*args)
    got = trwkv.wkv_scan_chunked(*(x.to(card) for x in args))
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)  # the kernel rounds as the loop
    for p in (2, 4, 8):
        wt, kt = (trwkv._split(x, p) for x in args[:2])
        want = tcp.cp_wkv_scan(wt, kt, algorithm="123")
        got = tcp.cp_wkv_scan(wt.to(card), kt.to(card), algorithm="123")
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("name,ranks", [("rwkv6_1_6b", (1, 1)),
                                        ("qwen2_moe_a2_7b", (2, 4)),
                                        ("jamba_1_5_large_398b", (1, 1))])
def test_smoke_model_on_card_matches_cpu(card, name, ranks):
    cfg = configs.get_smoke(name)
    tree = tparams.init_params(cfg, 0, "cpu")  # whole: each model cuts it
    host = Model(cfg, ranks, device="cpu")
    hp = host.load_params(tree)
    dev = Model(cfg, ranks, device=card)
    dp = dev.load_params({
        "top": {k: v.to(card) for k, v in tree["top"].items()},
        "blocks": tuple({k: v.to(card) for k, v in b.items()}
                        for b in tree["blocks"])})
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, (4, 16)).astype(np.int32)
    se.reset_launch_counts()
    got, _ = dev.forward(dp, torch.from_numpy(prompts).to(card))
    launched = se.launch_counts()
    want, _ = host.forward(hp, torch.from_numpy(prompts))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    pattern = cfg.pattern()
    if any(s.kind in ("rwkv", "mamba") for s in pattern):
        assert launched["affine_chunk"] > 0
    if any(s.use_moe for s in pattern):
        assert launched["moe_routing"] > 0
    assert np.array_equal(serve_loop(dev, dp, prompts, 4).tokens,
                          serve_loop(host, hp, prompts, 4).tokens)
