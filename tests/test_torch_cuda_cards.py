"""The scan and its consumers across cards: a ``WorkerPool`` over NCCL
with one process a card (marked ``cuda``; each test decides when it
runs whether there are the cards it needs, and skips where there are
not).

Process k runs on card k and holds P ranks; messages travel as device
tensors with no staging through the host.  Every run is held bit for
bit against ``StackedExecutor`` (or the stacked consumer) on card 0:
schedules of every family (shifts, the butterfly, all-gathers over
sub-groups, the ring, the block family, scan_total), the mirrored view,
``cp_ssm_scan`` / ``cp_wkv_scan`` forward and backward and
``dispatch_slots`` through ``WorkerPool.call``; every process launches
the IR's round kernels and the crossing messages are
``expected_messages``'.  With one card, the pool must refuse NCCL with
two processes.  ``SPMDExecutor.all_reduce`` gives every process of a
group the bits of the stacked ``sum_in_order`` on card 0, over gloo on
one card and over NCCL across four, and the dense smoke models, RWKV6
and Jamba served with their layers and mixers split over "model" give
the stacked model's tokens (the gloo tests need one card), and the smoke
families trained over processes give the stacked training run's losses,
grad norms and gradients on the same parameters, each process's
collectives ``params.train_collectives``'.

Run on a machine with four cards:
    python -m pytest -q -m cuda tests/test_torch_cuda_cards.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import scan_api as sa
from repro_torch.core import schedule as sch
from repro_torch.dist import WorkerPool
from repro_torch.models import context_parallel as cpl
from repro_torch.models import moe

pytestmark = pytest.mark.cuda

ROUND_KERNELS = ("combine", "exchange", "scan_reduce")
P = 2  # ranks a process


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@pytest.fixture(scope="module")
def pool():
    n = min(_cards(), 4)
    if n < 2:
        pytest.skip(f"needs two CUDA cards or more, found {n}")
    with WorkerPool(n, p_intra=P, backend="nccl", timeout=120) as pl:
        yield pl


def _launches(res):
    return [sum(n for k in ROUND_KERNELS for n in ln.get(k, {}).values())
            for ln in res.launches]


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _stacked(sched, x, monoid, flip=False):
    """The stacked executor's output leaves on card 0, as numpy (with
    ``flip``, of the rows reversed, reversed back)."""
    def to(v):
        return torch.from_numpy(np.ascontiguousarray(v[::-1] if flip else v)
                                ).cuda()

    x = tuple(map(to, x)) if isinstance(x, tuple) else to(x)
    out = sch.StackedExecutor("cuda:0").execute(sched, x, monoid)
    leaves = [t.cpu().numpy() for t in _leaves(out)]
    return [t[::-1] for t in leaves] if flip else leaves


def test_nccl_refuses_two_processes_on_one_card():
    if _cards() < 1:
        pytest.skip("needs a CUDA card")
    with pytest.raises(ValueError, match="nccl wants one card a process"):
        WorkerPool(2, backend="nccl", device="cuda:0", timeout=10)
    with pytest.raises(ValueError, match=f"{_cards() + 1} processes"):
        WorkerPool(_cards() + 1, backend="nccl", timeout=10)


def test_each_process_on_its_card(pool):
    x = np.arange(pool.p * 3, dtype=np.int64).reshape(pool.p, 3)
    pl = sa.plan(sa.ScanSpec(kind="exclusive", monoid="add",
                             algorithm="123"), pool.p, nbytes=24)
    res = pool.run(pl.schedule(), x)
    assert [m["device"] for m in res.memory] == \
        [f"cuda:{k}" for k in range(pool.nprocs)]
    assert pool.cards == pool.nprocs
    assert np.array_equal(res.outputs, _stacked(pl.schedule(), x, "add")[0])


SCHEDULES = [("exclusive", a, None) for a in
             ("123", "1doubling", "two_op", "native", "ring", "halving")] + [
    ("scan_total", "auto", None), ("exclusive", "native", "grid"),
    ("exclusive", "two_op", "grid")]


@pytest.mark.parametrize("mirrored", (False, True), ids=("plain", "mirror"))
@pytest.mark.parametrize("name", ("xor", "affine"))
@pytest.mark.parametrize("kind,alg,axes", SCHEDULES,
                         ids=["-".join(filter(None, c)) for c in SCHEDULES])
def test_schedules_across_cards(pool, kind, alg, axes, name, mirrored):
    p = pool.p
    kw = dict(kind=kind, monoid=name, algorithm=alg)
    if axes:  # ("pod", "data") = (2, p / 2): on four cards a "data"
        # group spans two processes, which gather over a sub-group
        pl = sa.plan(sa.ScanSpec(**kw, axis_name=("pod", "data")),
                     (2, p // 2), nbytes=8 * 1001)
    else:
        pl = sa.plan(sa.ScanSpec(**kw, segments=3 if alg == "ring" else 1),
                     p, nbytes=8 * 1001)
    sched = pl.schedule()
    rng = np.random.default_rng(len(sched.steps))
    x = rng.integers(-(1 << 62), 1 << 62, (p, 1001), dtype=np.int64) \
        if name == "xor" else (rng.standard_normal((p, 1001)),
                               rng.standard_normal((p, 1001)))
    res = pool.run(sched, x, monoid=name, mirrored=mirrored)
    got, want = _leaves(res.outputs), _stacked(sched, x, name, flip=mirrored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    commutative = name == "xor"
    assert _launches(res) == \
        [sched.kernel_launches(commutative, fused=True)] * pool.nprocs
    one = torch.from_numpy(x[0]) if name == "xor" else \
        tuple(torch.from_numpy(v[0]) for v in x)
    assert (res.transport["msgs"], res.transport["bytes"]) == \
        sch.expected_messages(sched, one, ranks_per_proc=P)
    assert res.transport["staged_copies"] == 0


@pytest.mark.parametrize("algo", ("auto", "123", "1doubling", "two_op"))
@pytest.mark.parametrize("kind", ("ssm", "wkv"))
def test_cp_scans_across_cards(pool, kind, algo):
    p = pool.p
    rng = np.random.default_rng(3)
    if kind == "ssm":
        shape = (p, 1, 64, 8, 4)
        a = rng.uniform(0.95, 1.0, shape).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
        fn = cpl.cp_ssm_scan
    else:
        a = rng.uniform(0.95, 1.0, (p, 1, 32, 2, 8, 1)).astype(np.float32)
        b = rng.standard_normal((p, 1, 32, 2, 8, 8)).astype(np.float32)
        fn = cpl.cp_wkv_scan
    gy = rng.standard_normal(b.shape).astype(np.float32)
    spec = cpl._carry_spec(None, algo)
    res = pool.call(f"cp_{kind}_scan", (a, b, gy), spec=spec, grad=True)
    xs = torch.from_numpy(a).cuda().requires_grad_()
    ys = torch.from_numpy(b).cuda().requires_grad_()
    h = fn(xs, ys, spec=spec)
    da, db = torch.autograd.grad(h, [xs, ys], torch.from_numpy(gy).cuda())
    for got, want in zip(res.outputs, (h.detach(), da, db)):
        assert np.array_equal(got, want.cpu().numpy())
    d = int(np.prod(b.shape[3:]))
    pl = sa.plan(spec, p, nbytes=2 * d * 4)
    assert [ln.get("affine_chunk_bwd") and sum(
        ln["affine_chunk_bwd"].values()) for ln in res.launches] == \
        [2] * pool.nprocs
    assert _launches(res) == [2 * pl.schedule().kernel_launches(
        False, fused=True)] * pool.nprocs
    msgs, nbytes = sch.expected_messages(
        pl.schedule(), (torch.zeros(1, d), torch.zeros(1, d)),
        ranks_per_proc=P)
    assert (res.transport["msgs"], res.transport["bytes"]) == \
        (2 * msgs, 2 * nbytes)
    assert res.transport["staged_copies"] == 0


@pytest.mark.parametrize("algo", ("auto", "123", "native"))
def test_dispatch_slots_across_cards(pool, algo):
    cfg = configs.get("qwen2-moe-a2.7b")
    rng = np.random.default_rng(5)
    top = np.argsort(rng.random((pool.p, 256, cfg.n_experts)),
                     axis=-1)[..., :cfg.top_k].astype(np.int32)
    spec = sa.ScanSpec(kind="exclusive", monoid="add", algorithm=algo)
    res = pool.call("dispatch_slots", top, arch="qwen2-moe-a2.7b", spec=spec)
    want = moe.dispatch_slots(cfg, torch.from_numpy(top).cuda(), spec=spec)
    for got, w in zip(res.outputs, want):
        assert np.array_equal(got, w.cpu().numpy())
    assert res.transport["staged_copies"] == 0


def test_hop_and_calibration_across_cards(pool):
    from repro_torch.core import tune

    assert 0 < pool.measure_hop(8, repeats=5) < 1.0
    assert 0 < pool.measure_hop(1 << 20, repeats=5) < 1.0
    prof = tune.calibrate_dist(pool, ms=(8192,), repeats=1)
    assert prof.mesh_fingerprint == \
        f"dist-cuda-nccl-cards{pool.nprocs}-procs{pool.nprocs}x{P}"


# ---------------------------------------------------------------------------
# the MoE layer and the served model, one rank a card (four cards)
# ---------------------------------------------------------------------------

QWEN = "qwen2-moe-a2.7b"


@pytest.fixture(scope="module")
def pool4():
    if _cards() < 4:
        pytest.skip(f"needs four CUDA cards, found {_cards()}")
    with WorkerPool(4, backend="nccl", timeout=120) as pl:
        yield pl


def _grid(ranks):
    return (("data", ranks[0]), ("model", ranks[1]))


@pytest.mark.parametrize("ranks", [(1, 4), (2, 2)])
@pytest.mark.parametrize("B,S,over", [(2, 1100, {}), (4, 1, {}),
                                      (3, 8, {"moe_weight_stationary":
                                              False})])
def test_moe_ffn_across_cards(pool4, ranks, B, S, over):
    """The smoke Qwen MoE layer in fp32, one mesh rank a card, against the
    stacked layer on card 0 on the same weights and input: the same
    (token, slot)s kept, aux and y within fp32 rounding (cuBLAS may pick
    other kernels at other batch counts); no copy staged."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD

    cfg = configs.get_smoke(QWEN, **over)
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    res = pool4.call("moe_ffn", np.stack([x] * 4), arch=QWEN, smoke=True,
                     ranks=ranks, batch=B, mesh=_grid(ranks), **over)
    mesh = make_host_mesh(*ranks)
    p = PD.init_moe_layer(cfg, 0, "cuda:0")
    y, aux, kept = moe._moe_ffn(cfg, p, torch.from_numpy(x).cuda(), mesh,
                                None, None)
    for k in range(4):
        rows = moe.held_rows(B, mesh, k)
        assert np.array_equal(res.outputs[2][k], kept[rows].cpu().numpy())
        np.testing.assert_allclose(res.outputs[0][k], y[rows].cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.outputs[1][k], aux.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    tr = res.transport
    assert tr["all_to_all"] == 4 * 2 and tr["staged_copies"] == 0


@pytest.mark.parametrize("ranks", [(1, 4), (2, 2)])
def test_serve_across_cards(pool4, ranks):
    """The smoke Qwen served one mesh rank a card gives the stacked
    model's tokens on card 0; each card holds its share of the experts
    (at (2, 2) their half of d: FSDP)."""
    from repro_torch.launch.serve import prompts_for, serve_loop, serve_procs
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model

    cfg = configs.get_smoke(QWEN)
    got = serve_procs(pool4, arch=QWEN, smoke=True, batch=4, prompt_len=16,
                      gen=6, seed=0, ranks=ranks)
    model = Model(cfg, ranks, device="cuda:0")
    want = serve_loop(model, model.init_params(0),
                      prompts_for(cfg, 4, 16, 0), 6)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    held = got["result"].outputs[3]
    total = PD.nbytes(model.params)
    assert (held[:, 1] * ranks[1] * ranks[0] == total["experts"]).all()
    assert [m["device"] for m in got["result"].memory] == \
        [f"cuda:{k}" for k in range(4)]
    assert got["result"].transport["staged_copies"] == 0


# --------------------- the dense layers split over "model" ---------------------

@pytest.fixture(scope="module")
def gloo4():
    """Four gloo processes on card 0 (staged through the host)."""
    if _cards() < 1:
        pytest.skip("needs a CUDA card")
    with WorkerPool(4, backend="gloo", device="cuda:0", timeout=120) as pl:
        yield pl


def _groups(ranks, axis):
    D, tp = ranks
    if axis == "model":
        return [[i * tp + j for j in range(tp)] for i in range(D)]
    return [[i * tp + j for i in range(D)] for j in range(tp)]


def _all_reduce_bits(pool, label):
    """``SPMDExecutor.all_reduce`` over "model" and "data" of the (1, 4)
    and (2, 2) grids in bf16 and fp32: every process of a group holds
    the bits of ``sum_in_order`` of its group's inputs on card 0."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 3, 4099)) * 10.0 ** rng.integers(
        -3, 4, (4, 3, 4099))).astype(np.float32)
    for ranks in [(1, 4), (2, 2)]:
        for axis in ("model", "data"):
            for dtype in (torch.bfloat16, torch.float32):
                res = pool.call("all_reduce", x, axis=axis,
                                dtype=str(dtype).split(".")[1],
                                mesh=_grid(ranks))
                for g in _groups(ranks, axis):
                    want = sch.sum_in_order(torch.stack(
                        [torch.from_numpy(x[k]).cuda().to(dtype)
                         for k in g])).float().cpu().numpy()
                    for k in g:
                        assert res.outputs[k].tobytes() == want.tobytes(), \
                            (label, ranks, axis, dtype, k)
                assert res.transport["staged_copies"] == 0 or \
                    pool.backend == "gloo"


def test_all_reduce_over_gloo_on_one_card(gloo4):
    _all_reduce_bits(gloo4, "gloo")


def test_all_reduce_over_nccl_across_cards(pool4):
    _all_reduce_bits(pool4, "nccl")


def _tp_serve(pool, name, ranks, over=None):
    """A smoke model (with the config overrides ``over``) served with its
    layers split over "model": the stacked model's tokens on card 0 (the
    same shards, summed in the same order), prefill logits within fp32
    rounding (cuBLAS may pick other kernels at other row counts), each
    process holding its share of the dense bytes; the all-reduces the
    code's count a call (``params.all_reduces``: with the MoE layers'
    d-sliced expert partials where every call is weight-stationary over
    two data processes)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import prompts_for, serve_loop, serve_procs
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model

    over = over or {}
    cfg = configs.get_smoke(name, **over)
    got = serve_procs(pool, arch=name, smoke=True, batch=4, prompt_len=16,
                      gen=6, seed=0, ranks=ranks, **over)
    model = Model(cfg, ranks, device="cuda:0")
    want = serve_loop(model, model.init_params(0),
                      prompts_for(cfg, 4, 16, 0), 6)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    np.testing.assert_allclose(got["prefill_logits"],
                               want.prefill_logits.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    mesh = make_host_mesh(*ranks)
    held = got["result"].outputs[3]
    for k in range(4):
        assert held[k, 0] == PD.share_nbytes(cfg, mesh, k)["dense"]
    tr = got["result"].transport
    ws = ranks[0] > 1 and cfg.n_experts > 0 and all(
        moe.moe_groups(cfg, 4, S, mesh).ws for S in (16, 1))
    assert tr["all_reduce"] == 4 * 6 * PD.all_reduces(cfg, model.split,
                                                      ws=ws)


@pytest.mark.parametrize("ranks", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", ["llama3_8b", "gemma2_9b"])
def test_tp_serve_over_gloo_on_one_card(gloo4, name, ranks):
    _tp_serve(gloo4, name, ranks)


@pytest.mark.parametrize("ranks", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", ["llama3_8b", "gemma2_9b"])
def test_tp_serve_across_cards(pool4, name, ranks):
    _tp_serve(pool4, name, ranks)
    assert [m["device"] for m in pool4.call(
        "serve", None, arch=name, smoke=True, batch=4, prompt_len=4, gen=1,
        ranks=ranks, mesh=_grid(ranks)).memory] == \
        [f"cuda:{k}" for k in range(4)]


# RWKV6 SMOKE with 4 wkv heads (its stock 2 do not split over 4 processes)
# and Jamba SMOKE (Mamba, attention, MoE): the mixers split over "model"
MIXERS = [("rwkv6_1_6b", {"d_model": 256, "n_heads": 4, "n_kv_heads": 4}),
          ("jamba_1_5_large_398b", {})]


@pytest.mark.parametrize("ranks", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name,over", MIXERS, ids=[m[0] for m in MIXERS])
def test_mixer_serve_over_gloo_on_one_card(gloo4, name, over, ranks):
    _tp_serve(gloo4, name, ranks, over)


@pytest.mark.parametrize("ranks", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name,over", MIXERS, ids=[m[0] for m in MIXERS])
def test_mixer_serve_across_cards(pool4, name, over, ranks):
    _tp_serve(pool4, name, ranks, over)


# ----------------------- training over processes -----------------------

# the smoke families trained at (2, 2) and (1, 4) (Qwen's MoE layers past
# the weight-stationary grouping too), fp32, 3 steps of 4 rows of 16 tokens
TRAINED = [("llama3_8b", {}, (2, 2)), ("llama3_8b", {}, (1, 4)),
           ("rwkv6_1_6b", MIXERS[0][1], (2, 2)),
           ("rwkv6_1_6b", MIXERS[0][1], (1, 4)),
           ("qwen2_moe_a2_7b", {}, (2, 2)),
           ("qwen2_moe_a2_7b", {"moe_weight_stationary": False}, (2, 2)),
           ("jamba_1_5_large_398b", {}, (2, 2))]


def _train_over(pool, name, over, ranks):
    """3 steps over ``pool`` against the stacked run on card 0 on the same
    parameters before each step (the processes' own, joined): each
    step's loss within rtol 1e-5 and grad_norm within 1e-4, step 0's
    gradients within 3e-5·max|g| + 1e-4·|g|, each process's collectives
    ``params.train_collectives``' and none staged over NCCL.  Held looser
    than on the CPU (``tests/test_torch_train_procs.py``) where the card
    measured more: the 4-head RWKV6's step-2 norm, about 15 800 (20 times
    step 0's), 1.1e-5 and 2.6e-5 off the stacked run's over gloo, the
    loss within 1e-5; one entry of its μ's 512 gradient entries 1.7e-5
    of the leaf's largest off, at (2, 2) over gloo and over NCCL."""
    from repro_torch import _tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as PD
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    B, S, steps = 4, 16, 3
    argv = ["--arch", name, "--smoke", "--steps", str(steps), "--batch",
            str(B), "--seq", str(S), "--data-mesh", str(ranks[0]),
            "--model-mesh", str(ranks[1])]
    got = T.train_procs(pool, argv, over=over, grads=True, params=True)
    cfg = configs.get_smoke(name, **over)
    mesh = make_host_mesh(*ranks)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B))
    tree = PD.init_params(cfg, 0, "cuda:0")
    for step in range(steps):
        if step:
            shares = [_tree.tree_map(lambda a, i=step - 1: a[i], p)
                      for p in got["params"]]
            tree = _tree.tree_map(lambda t: t.cuda(),
                                  PD.join_shares(shares, cfg, mesh))
        model = Model(cfg, ranks, device="cuda:0")
        params = model.load_params(tree, trainable=True)
        b = data.batch(step)
        loss, _ = model.loss(params, {k: torch.from_numpy(b[k]).cuda()
                                      for k in ("tokens", "labels")})
        grads = torch.autograd.grad(loss, _tree.leaves(params))
        m = got["metrics"][step]
        np.testing.assert_allclose(m["loss"], float(loss.detach()),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"],
                                   float(adamw.global_norm(grads)),
                                   rtol=1e-4)
        if step == 0:
            joined = _tree.leaves(PD.join_shares(got["grads"], cfg, mesh))
            for g, w in zip(joined, grads):
                w = w.cpu().numpy()
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=1e-4,
                    atol=3e-5 * max(float(np.abs(w).max()), 1e-30))
    for k, per in enumerate(got["collectives"]):
        want = PD.train_collectives(cfg, mesh, k, batch=B, seq=S)
        for step in per:
            assert {kind: {"calls": c["calls"], "bytes": c["bytes"]}
                    for kind, c in step.items()} == want
    if pool.backend == "nccl":
        assert got["result"].transport["staged_copies"] == 0


@pytest.mark.parametrize("name,over,ranks", TRAINED,
                         ids=[f"{n}-{r[0]}x{r[1]}-{i}"
                              for i, (n, _, r) in enumerate(TRAINED)])
def test_train_over_gloo_on_one_card(gloo4, name, over, ranks):
    _train_over(gloo4, name, over, ranks)


@pytest.mark.parametrize("name,over,ranks", TRAINED,
                         ids=[f"{n}-{r[0]}x{r[1]}-{i}"
                              for i, (n, _, r) in enumerate(TRAINED)])
def test_train_across_cards(pool4, name, over, ranks):
    _train_over(pool4, name, over, ranks)
