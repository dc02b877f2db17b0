"""The scan's consumers over process-held ranks: the context-parallel
scans and the MoE dispatch offsets through ``WorkerPool.call``.

Each process of a gloo pool on the CPU holds a block of P ranks
(``SPMDExecutor(ranks_per_proc=P)``), as the JAX package holds one rank
a device under ``shard_map``.  Two pools serve the module, (2 processes
× 2 ranks) and (4 × 1).  Every case runs the same inputs, made from a
seed with numpy, through the pool and through the stacked port
(``StackedExecutor``, all p ranks on one leading axis of one process's
tensors):

- ``cp_ssm_scan`` / ``cp_wkv_scan`` forward, and their gradients (da,
  db), for auto, 123, 1doubling and two_op: bit for bit the stacked
  port's, and the forward within rtol = atol = 2e-4 of the JAX package's
  sequential ``ssm_scan_chunked`` / ``wkv_scan_chunked`` over the unsplit
  sequence (``tests/test_torch_context_parallel.py``'s tolerance);
- rounds and ⊕ (process 0's ``collect_stats``) the plan's, twice the
  plan's with the backward, whose carry runs the same plan on the
  executor's mirrored view; every process's kernel launches the IR's;
  crossing messages and bytes ``schedule.expected_messages``' (twice
  with the backward);
- the mirrored view alone on the schedule families (shifts, the
  butterfly, all-gathers over sub-groups, the ring, the block family,
  scan_total): the stacked run of the reversed ranks, and exactly
  ``expected_messages``;
- ``dispatch_slots``: bit for bit the stacked port's and the JAX
  package's pieces (routing per rank in interpret mode, the simulator's
  scan_total of the counts, the keep/slot formula).

``devices_for``, the pool's device rule, must refuse NCCL with more
processes than cards or two processes on one card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import scan_api as rsa
from repro.core import schedule as rsch
from repro.kernels import ops as rops
from repro.models import params as rparams
from repro.models.mamba import ssm_scan_chunked as ref_ssm
from repro.models.rwkv import wkv_scan_chunked as ref_wkv
from repro_torch import configs as tconfigs
from repro_torch.core import monoid as tmon
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.dist import WorkerPool
from repro_torch.dist import launcher
from repro_torch.models import context_parallel as tcp
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams

POOLS = ((2, 2), (4, 1))  # (nprocs, p_intra): p = 4
TIMEOUT = 60
TOL = 2e-4
ALGOS = ("auto", "123", "1doubling", "two_op")
SSM_B, SSM_S, SSM_D = 2, 48, 8
WKV_B, WKV_S, WKV_H, WKV_HD = 1, 32, 2, 4


@pytest.fixture(scope="module", params=POOLS,
                ids=lambda c: f"{c[0]}x{c[1]}")
def pool(request):
    nprocs, P = request.param
    with WorkerPool(nprocs, p_intra=P, backend="gloo", device="cpu",
                    timeout=TIMEOUT) as pl:
        yield pl


def _split(x: np.ndarray, p: int) -> np.ndarray:
    """(B, S, ...) -> (p, B, S/p, ...)."""
    B, S = x.shape[:2]
    return np.ascontiguousarray(
        x.reshape(B, p, S // p, *x.shape[2:]).swapaxes(0, 1))


def _join(h: np.ndarray) -> np.ndarray:
    p, B, s = h.shape[:3]
    return h.swapaxes(0, 1).reshape(B, p * s, *h.shape[3:])


@functools.cache
def _case(kind: str):
    """(x, y, gY) of the unsplit sequence and the JAX package's forward
    over it from a zero state."""
    if kind == "ssm":
        rng = np.random.default_rng(0)
        shape = (SSM_B, SSM_S, SSM_D)
        x = rng.uniform(0.7, 1.0, shape).astype(np.float32)
        y = rng.standard_normal(shape).astype(np.float32)
        h, _ = ref_ssm(jnp.asarray(x), jnp.asarray(y),
                       jnp.zeros((SSM_B, SSM_D), jnp.float32))
    else:
        rng = np.random.default_rng(1)
        x = rng.uniform(0.8, 1.0, (WKV_B, WKV_S, WKV_H, WKV_HD, 1)) \
            .astype(np.float32)
        y = (rng.standard_normal((WKV_B, WKV_S, WKV_H, WKV_HD, WKV_HD))
             * 0.1).astype(np.float32)
        h, _ = ref_wkv(jnp.asarray(x), jnp.asarray(y),
                       jnp.zeros((WKV_B, WKV_H, WKV_HD, WKV_HD),
                                 jnp.float32))
    gy = np.random.default_rng(2).standard_normal(y.shape) \
        .astype(np.float32)
    return (x, y, gy), np.asarray(h)


FNS = {"ssm": tcp.cp_ssm_scan, "wkv": tcp.cp_wkv_scan}


def _stacked(kind, p, spec, grad):
    """The stacked port's h (and da, db) on the same split inputs."""
    (x, y, gy), _ = _case(kind)
    xs = torch.from_numpy(_split(x, p)).requires_grad_(grad)
    ys = torch.from_numpy(_split(y, p)).requires_grad_(grad)
    out = FNS[kind](xs, ys, spec=spec)
    if not grad:
        return (out.numpy(),)
    da, db = torch.autograd.grad(out, [xs, ys],
                                 torch.from_numpy(_split(gy, p)))
    return out.detach().numpy(), da.numpy(), db.numpy()


def _check_counts(pool, res, pl, per_rank, times: int):
    """Process 0's rounds and ⊕, every process's recorded launches, and
    the crossing messages and bytes: ``times`` runs of ``pl``."""
    st = res.stats
    assert (st["rounds"], st["op_applications"]) == (
        times * pl.rounds, times * pl.op_applications)
    ir = pl.schedule().kernel_launches(
        tmon.get(pl.spec.monoid).commutative, fused=True)
    assert [s["kernel_launches"] for s in res.rank_stats] == \
        [times * ir] * pool.nprocs
    assert res.launches == [{}] * pool.nprocs  # the CPU's plain versions
    msgs, nbytes = tsch.expected_messages(pl.schedule(), per_rank,
                                          ranks_per_proc=pool.p_intra)
    assert (res.transport["msgs"], res.transport["bytes"]) == (
        times * msgs, times * nbytes)
    assert res.transport["staged_copies"] == 0


def _carry(kind, p, spec):
    """The carry's plan and one rank's carry payload."""
    (x, y, _), _ = _case(kind)
    d = int(np.prod(y.shape[2:]))
    bsz = y.shape[0]
    pl = tsa.plan(spec, p, nbytes=2 * bsz * d * 4)
    return pl, (torch.zeros(bsz, d), torch.zeros(bsz, d))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", ("ssm", "wkv"))
def test_cp_forward_through_the_pool(pool, kind, algo):
    (x, y, _), want = _case(kind)
    p = pool.p
    spec = tcp._carry_spec(None, algo)
    res = pool.call(f"cp_{kind}_scan", (_split(x, p), _split(y, p)),
                    spec=spec)
    (stacked,) = _stacked(kind, p, spec, grad=False)
    assert res.outputs.shape == stacked.shape
    assert np.array_equal(res.outputs, stacked)
    np.testing.assert_allclose(_join(res.outputs), want, rtol=TOL, atol=TOL)
    pl, one = _carry(kind, p, spec)
    _check_counts(pool, res, pl, one, 1)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", ("ssm", "wkv"))
def test_cp_gradients_through_the_pool(pool, kind, algo):
    (x, y, gy), _ = _case(kind)
    p = pool.p
    spec = tcp._carry_spec(None, algo)
    res = pool.call(f"cp_{kind}_scan",
                    (_split(x, p), _split(y, p), _split(gy, p)),
                    spec=spec, grad=True)
    for name, got, want in zip(("h", "da", "db"), res.outputs,
                               _stacked(kind, p, spec, grad=True)):
        assert got.shape == want.shape, name
        assert np.array_equal(got, want), name
    # the backward's carry: the forward's plan on the mirrored view
    pl, one = _carry(kind, p, spec)
    _check_counts(pool, res, pl, one, 2)


def test_call_takes_every_rank(pool):
    (x, y, _), _ = _case("ssm")
    p = pool.p
    with pytest.raises(ValueError, match=f"leading axis of {p}"):
        pool.call("cp_ssm_scan", (_split(x, 2 * p), _split(y, 2 * p)),
                  spec=tcp.CARRY_SPEC)
    res = pool.call("cp_ssm_scan", (_split(x, p), _split(y, p)),
                    spec=tcp.CARRY_SPEC)
    assert res.outputs.shape[0] == p


def test_stacked_block_must_be_the_executors():
    """A block executor's call refuses tensors of another block size,
    before any message, so the pool's entries need no check of their
    own."""
    ex = type("Block", (tsch.SPMDExecutor,), {"__init__": lambda s: None})()
    ex.ranks_per_proc, ex.world, ex.lead = 2, 2, 1
    ex.p = 4
    with pytest.raises(ValueError, match="block of 2 ranks"):
        tcp.cp_ssm_scan(torch.ones(3, 1, 4, 2), torch.ones(3, 1, 4, 2),
                        executor=ex)
    with pytest.raises(ValueError, match="block of 2 ranks"):
        tmoe.dispatch_slots(tconfigs.get_smoke("qwen2-moe-a2.7b"),
                            torch.zeros(3, 4, 2, dtype=torch.int32),
                            executor=ex)


MIRRORED = (("exclusive", "123", None), ("exclusive", "1doubling", None),
            ("exclusive", "two_op", None), ("exclusive", "native", None),
            ("exclusive", "ring", None), ("exclusive", "halving", None),
            ("scan_total", "auto", None),
            ("exclusive", "native", ("pod", "data")),
            ("exclusive", "123", ("pod", "data")))


@pytest.mark.parametrize("name", ("add", "affine"))
@pytest.mark.parametrize("kind,alg,axes", MIRRORED,
                         ids=["-".join(filter(None, (k, a, "x".join(ax or ())
                                                     )))
                              for k, a, ax in MIRRORED])
def test_mirrored_view(pool, kind, alg, axes, name):
    """Row r of the payload is the schedule's rank p−1−r: the stacked
    run of the reversed rows, reversed back, with exactly the messages
    and bytes ``expected_messages`` gives."""
    p = pool.p
    kw = dict(kind=kind, monoid=name, algorithm=alg)
    if axes is None:
        pl = tsa.plan(tsa.ScanSpec(**kw, segments=2 if alg == "ring"
                                   else 1), p, nbytes=64)
    else:
        pl = tsa.plan(tsa.ScanSpec(**kw, axis_name=axes), (2, p // 2),
                      nbytes=64)
    sched = pl.schedule()
    rng = np.random.default_rng(len(sched.steps))
    x = rng.integers(0, 1 << 30, (p, 8)).astype(np.int64) \
        if name == "add" else (rng.standard_normal((p, 8)),
                               rng.standard_normal((p, 8)))
    flip = functools.partial(jax.tree.map, lambda a: np.asarray(a)[::-1])
    want = tsch.StackedExecutor("cpu").execute(
        sched, jax.tree.map(torch.from_numpy,
                            jax.tree.map(np.ascontiguousarray, flip(x))),
        name)
    want = flip(jax.tree.map(lambda t: t.numpy(), want))
    res = pool.run(sched, x, monoid=name, mirrored=True)
    for g, w in zip(jax.tree.leaves(res.outputs), jax.tree.leaves(want)):
        assert np.array_equal(g, w)
    assert (res.stats["rounds"], res.stats["op_applications"]) == (
        pl.rounds, pl.op_applications)
    one = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)[0]), x)
    assert (res.transport["msgs"], res.transport["bytes"]) == \
        tsch.expected_messages(sched, one, ranks_per_proc=pool.p_intra)


def _top_e(p, n0, k, n_experts, seed):
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((p, n0, n_experts)),
                      axis=-1)[..., :k].astype(np.int32)


def _jax_dispatch(cfg, top_e, algorithm):
    """The JAX package's pieces: routing per rank (interpret mode), the
    simulator's scan_total of the counts, moe.py's keep/slot formula."""
    p, n0, k = top_e.shape
    e_pad = rparams.experts_padded(cfg)
    pos, counts = zip(*(rops.moe_routing(jnp.asarray(top_e[r]), e_pad,
                                         interpret=True) for r in range(p)))
    pos = np.stack([np.asarray(v) for v in pos])
    counts = np.stack([np.asarray(v) for v in counts]).astype(np.int32)
    pl = rsa.plan(rsa.ScanSpec(kind="scan_total", monoid="add",
                               algorithm=algorithm), p, nbytes=4 * e_pad)
    offsets, totals = (np.asarray(v) for v in pl.execute(
        counts, executor=rsch.SimulatorExecutor()))
    cap = max(8, int(cfg.capacity_factor * n0 * k / e_pad))
    flat_e, flat_pos = top_e.reshape(p, -1), pos.reshape(p, -1)
    gpos = np.take_along_axis(offsets, flat_e, axis=1) + flat_pos
    keep = (flat_pos < cap) & (gpos < cap * p)
    slot = np.where(keep, flat_e * cap + flat_pos, e_pad * cap)
    return pos, offsets, totals, keep, slot.astype(np.int32)


@pytest.mark.parametrize("algo", ("auto", "123", "two_op"))
@pytest.mark.parametrize("arch,smoke,n0", (("qwen2-moe-a2.7b", False, 48),
                                           ("qwen2-moe-a2.7b", True, 64)))
def test_dispatch_slots_through_the_pool(pool, arch, smoke, n0, algo):
    """Offsets, totals and the global capacity are the p ranks' (the
    smoke config at 64 tokens drops past capacity)."""
    cfg = (tconfigs.get_smoke if smoke else tconfigs.get)(arch)
    p = pool.p
    top_e = _top_e(p, n0, cfg.top_k, cfg.n_experts, seed=n0)
    if smoke:
        top_e[..., 0] = 0  # every token on expert 0: the capacity bites
    spec = tsa.ScanSpec(kind="exclusive", monoid="add", algorithm=algo)
    res = pool.call("dispatch_slots", top_e, arch=arch, smoke=smoke,
                    spec=spec)
    stacked = tmoe.dispatch_slots(cfg, torch.from_numpy(top_e), spec=spec)
    rcfg = (rconfigs.get_smoke if smoke else rconfigs.get)(arch)
    want = _jax_dispatch(rcfg, top_e, algo)
    names = ("positions", "offsets", "totals", "keep", "slot")
    for name, got, s, w in zip(names, res.outputs, stacked, want):
        assert got.shape == w.shape and got.dtype == w.dtype, name
        assert np.array_equal(got, s.numpy()), name
        assert np.array_equal(got, w), name
    if smoke:
        assert not res.outputs[3].all()
    e_pad = tparams.experts_padded(cfg)
    pl = tsa.plan(tsa.ScanSpec(kind="scan_total", monoid="add",
                               algorithm=algo), p, nbytes=4 * e_pad)
    assert (res.stats["rounds"], res.stats["op_applications"]) == (
        pl.rounds, pl.op_applications)
    assert (res.transport["msgs"], res.transport["bytes"]) == \
        tsch.expected_messages(pl.schedule(), torch.zeros(e_pad,
                                                          dtype=torch.int32),
                               ranks_per_proc=pool.p_intra)


def test_drawn_inputs_and_digests(pool):
    """Inputs drawn in each process and outputs returned as digests:
    each rank's digests those of the stacked run on ``Draw.full``."""
    p = pool.p
    draw = launcher.Draw(shapes=((1, 12, 8),) * 3,
                         kinds=(("uniform", 0.9, 1.0), ("normal",),
                                ("normal",)), seed=7)
    spec = tcp._carry_spec(None, "123")
    res = pool.call("cp_ssm_scan", draw, spec=spec, grad=True, digest=True)
    a, b, gy = draw.full(p, "cpu")
    assert all(np.array_equal(g, launcher.digest(t))
               for g, t in zip(res.inputs, (a, b, gy)))
    xs, ys = a.requires_grad_(), b.requires_grad_()
    out = tcp.cp_ssm_scan(xs, ys, spec=spec)
    da, db = torch.autograd.grad(out, [xs, ys], gy)
    for got, want in zip(res.outputs, (out.detach(), da, db)):
        assert got.shape == (p, 2)
        assert np.array_equal(got, launcher.digest(want))


def test_unknown_entry_raises(pool):
    with pytest.raises(ValueError, match="no entry"):
        pool.call("no_such_entry", np.zeros((pool.p, 2)))


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64,
                                   torch.int32, torch.bool, torch.bfloat16))
def test_digest_sees_every_bit(dtype):
    t = (torch.arange(3 * 37, dtype=torch.float64).reshape(3, 37) * 0.37) \
        .to(dtype)
    base = launcher.digest(t)
    assert base.shape == (3, 2)
    assert np.array_equal(base, launcher.digest(t.clone()))
    raw = t.clone().reshape(3, -1).view(torch.uint8)
    for row, byte in ((0, 0), (1, 5), (2, raw.shape[1] - 1)):
        flipped = raw.clone()
        flipped[row, byte] ^= 1
        got = launcher.digest(flipped.view(dtype).reshape(t.shape))
        assert not np.array_equal(got[row], base[row])
        others = [r for r in range(3) if r != row]
        assert np.array_equal(got[others], base[others])


# ---------------------------------------------------------------------------
# the pool's devices
# ---------------------------------------------------------------------------


def test_devices_for_nccl_gives_each_process_its_card():
    assert launcher.devices_for(4, "nccl", None, 4) == [
        torch.device("cuda", k) for k in range(4)]
    assert launcher.devices_for(2, "nccl", "cuda", 8) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert launcher.devices_for(2, "nccl", ["cuda:3", "cuda:1"], 4) == [
        torch.device("cuda", 3), torch.device("cuda", 1)]
    assert launcher.devices_for(1, "nccl", "cuda:2", 4) == [
        torch.device("cuda", 2)]


def test_devices_for_gloo_shares_one_device():
    assert launcher.devices_for(3, "gloo", "cpu", 0) == \
        [torch.device("cpu")] * 3
    assert launcher.devices_for(2, "gloo", "cuda:1", 2) == \
        [torch.device("cuda", 1)] * 2
    assert launcher.devices_for(2, "gloo", None, 1) == \
        [torch.device("cuda", 0)] * 2


@pytest.mark.parametrize("nprocs,device,cards,match", (
    (2, None, 1, "2 processes, 1 cards"),
    (4, None, 0, "4 processes, 0 cards"),
    (2, "cuda:0", 4, "share 1 of the 4 cards"),
    (2, ["cuda:1", "cuda:1"], 4, "share 1 of the 4 cards"),
    (2, ["cuda:0", "cuda:5"], 4, "card 5 is not among the 4"),
    (2, "cpu", 4, "CUDA tensors only"),
    (3, ["cuda:0", "cuda:1"], 4, "2 devices for 3 processes")))
def test_devices_for_refuses_nccl(nprocs, device, cards, match):
    with pytest.raises(ValueError, match=match):
        launcher.devices_for(nprocs, "nccl", device, cards)


def test_nccl_pool_refuses_before_spawning():
    import multiprocessing

    before = len(multiprocessing.active_children())
    with pytest.raises(ValueError, match="cards present"):
        WorkerPool(2, backend="nccl", timeout=5)
    assert len(multiprocessing.active_children()) == before
