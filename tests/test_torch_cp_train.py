"""Training through the context-parallel scans and remat policy "dots",
against the JAX package, on the CPU.

``cp_ssm_scan`` / ``cp_wkv_scan`` take gradients: their backward runs
the exclusive affine scan over the ranks in reverse order under the
forward's plan, between two ``affine_chunk_bwd`` launches (their plain
versions here).  Gradients are held against ``jax.vjp`` of the
reference's sequential ``ssm_scan_chunked`` / ``wkv_scan_chunked`` over
the unsplit sequence at 2e-4 of the gradient's scale (the JAX package's
tolerance for its cp carry, ``tests/test_context_parallel.py``): the
split scan adds the same terms in another order.  fp64 gradcheck holds
the backward to finite differences.

``Model.loss`` under ``sharding_strategy="fsdp_sp"`` (the RWKV wkv
recurrence context-parallel, the MoE dispatch split by sequence shard)
and under remat policy "dots" against ``jax.value_and_grad`` of the
reference's loss on its (1, 1) mesh: the reference's rule that fsdp_sp
computes the single-device result (``tests/test_strategies.py``), at
``tests/test_torch_train.py``'s tolerances.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro.core import scan_api as rsa
from repro.models import context_parallel as rcp
from repro.data.pipeline import synthetic_batch as ref_synthetic_batch
from repro.models.mamba import ssm_scan_chunked as ref_ssm
from repro.models.model import Model as RModel
from repro.models.rwkv import wkv_scan_chunked as ref_wkv
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch.benchmarks.dist_bench import REFERENCE_PROFILE
from repro_torch.core import scan_api as tsa
from repro_torch.core import schedule as tsch
from repro_torch.kernels import scan_engine as se
from repro_torch.models import context_parallel as tcp
from repro_torch.models import params as tparams
from repro_torch.models.model import DOTS
from repro_torch.models.model import Model as TModel

SCAN_TOL = 2e-4
ATOL, RTOL = 3e-4, 3e-3
GRAD_ATOL, GRAD_RTOL = 1e-3, 1e-2
ALGOS = ("auto", "123", "1doubling", "two_op")


def _close(got, want, atol, rtol, what=""):
    """got within atol·max|want| + rtol·|want| of want."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, atol=atol * max(scale, 1e-12),
                               rtol=rtol, err_msg=what)


def _split(x: np.ndarray, p: int) -> torch.Tensor:
    """(B, S, ...) -> (p, B, S/p, ...), a leaf that takes gradients."""
    B, S = x.shape[:2]
    t = torch.from_numpy(x).reshape(B, p, S // p, *x.shape[2:])
    return t.transpose(0, 1).contiguous().requires_grad_()


def _join(t: torch.Tensor) -> np.ndarray:
    p, B, s = t.shape[:3]
    return t.detach().transpose(0, 1).reshape(B, p * s,
                                              *t.shape[3:]).numpy()


# ---------------------------------------------------------------------------
# the cp scans' backward
# ---------------------------------------------------------------------------

SSM_B, SSM_S, SSM_D = 2, 240, 16  # S divides by every p below
WKV_B, WKV_S, WKV_H, WKV_HD = 1, 128, 2, 8


@functools.cache
def _ssm_case():
    """(a, b, gY) and the reference's (h, da, db) over the whole
    sequence from h = 0."""
    rng = np.random.default_rng(0)
    shape = (SSM_B, SSM_S, SSM_D)
    a = rng.uniform(0.7, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    h0 = jnp.zeros((SSM_B, SSM_D), jnp.float32)
    (h, hf), vjp = jax.vjp(lambda a_, b_: ref_ssm(a_, b_, h0),
                           jnp.asarray(a), jnp.asarray(b))
    da, db = vjp((jnp.asarray(gy), jnp.zeros_like(hf)))
    return (a, b, gy), tuple(map(np.asarray, (h, da, db)))


@functools.cache
def _wkv_case():
    """(w, kv, gY) and the reference's (S_prev, dw, dkv) over the whole
    sequence from S = 0."""
    rng = np.random.default_rng(1)
    w = rng.uniform(0.8, 1.0, (WKV_B, WKV_S, WKV_H, WKV_HD, 1)) \
        .astype(np.float32)
    kv = (rng.standard_normal((WKV_B, WKV_S, WKV_H, WKV_HD, WKV_HD))
          * 0.1).astype(np.float32)
    gy = rng.standard_normal(kv.shape).astype(np.float32)
    s0 = jnp.zeros((WKV_B, WKV_H, WKV_HD, WKV_HD), jnp.float32)
    (s, sf), vjp = jax.vjp(lambda w_, kv_: ref_wkv(w_, kv_, s0),
                           jnp.asarray(w), jnp.asarray(kv))
    dw, dkv = vjp((jnp.asarray(gy), jnp.zeros_like(sf)))
    return (w, kv, gy), tuple(map(np.asarray, (s, dw, dkv)))


CASES = {"ssm": (_ssm_case, tcp.cp_ssm_scan),
         "wkv": (_wkv_case, tcp.cp_wkv_scan)}


def _cp_grads(kind, p, algo, executor=None):
    """The port's output and (d first, d second) through the cp scan,
    the backward alone under ``collect_stats``."""
    make, fn = CASES[kind]
    (x, y, gy), _ = make()
    xs, ys = _split(x, p), _split(y, p)
    out = fn(xs, ys, algorithm=algo, executor=executor)
    with tsch.collect_stats() as st:
        got = torch.autograd.grad(out, [xs, ys], _split(gy, p).detach())
    return out, got, st


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
def test_cp_ssm_grads_match_jax_vjp(p, algo):
    _, (h, da, db) = _ssm_case()
    out, (ga, gb), _ = _cp_grads("ssm", p, algo)
    _close(_join(out), h, SCAN_TOL, SCAN_TOL, "h")
    _close(_join(ga), da, SCAN_TOL, SCAN_TOL, "da")
    _close(_join(gb), db, SCAN_TOL, SCAN_TOL, "db")


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("p", [2, 4])
def test_cp_wkv_grads_match_jax_vjp(p, algo):
    _, (s, dw, dkv) = _wkv_case()
    out, (gw, gkv), _ = _cp_grads("wkv", p, algo)
    assert tuple(gw.shape) == (p, WKV_B, WKV_S // p, WKV_H, WKV_HD, 1)
    _close(_join(out), s, SCAN_TOL, SCAN_TOL, "S_prev")
    _close(_join(gw), dw, SCAN_TOL, SCAN_TOL, "dw")
    _close(_join(gkv), dkv, SCAN_TOL, SCAN_TOL, "dkv")


@pytest.mark.parametrize("algo", ["auto", "123"])
@pytest.mark.parametrize("kind,p,width", [("ssm", 3, SSM_D),
                                          ("ssm", 8, SSM_D),
                                          ("wkv", 4,
                                           WKV_H * WKV_HD * WKV_HD)])
def test_cp_backward_runs_the_forward_plan(kind, p, width, algo):
    """The backward's measured rounds and ⊕ are the forward plan's: one
    run of the carry's schedule over the reversed ranks; on the CPU no
    kernel launches (the plain versions)."""
    before = se.launch_counts()
    _, _, st = _cp_grads(kind, p, algo, executor=tsch.StackedExecutor("cpu"))
    B = SSM_B if kind == "ssm" else WKV_B
    pl = tsa.plan(tcp._carry_spec(None, algo), p, nbytes=2 * B * width * 4)
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    assert se.launch_counts() == before


def test_cp_backward_runs_the_forward_plan_from_any_thread():
    """On the card autograd runs the backward on a device thread: it
    runs the plan the forward ran (the cost model in force is the
    forward thread's), and counts into the collector the forward's
    thread has open.  Here the forward prices under a γ-heavy model that
    picks a ring; the backward, called from another thread without it,
    still runs that ring and counts into this thread's collector."""
    (a, b, gy), _ = _ssm_case()
    p = 8
    xs, ys = _split(a, p), _split(b, p)
    cm = tsa.CostModel(alpha=0.0, beta=1e-9, gamma=1.0)
    with tsa.use_cost_model(cm):
        out = tcp.cp_ssm_scan(xs, ys)
        pl = tsa.plan(tcp.CARRY_SPEC, p, nbytes=2 * SSM_B * SSM_D * 4)
    assert pl.algorithm != tsa.plan(tcp.CARRY_SPEC, p,
                                    nbytes=2 * SSM_B * SSM_D * 4).algorithm
    got = []
    with tsch.collect_stats() as st:
        worker = threading.Thread(target=lambda: got.extend(
            torch.autograd.grad(out, [xs, ys], _split(gy, p).detach())))
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive() and len(got) == 2
    assert (st.rounds, st.op_applications) == (pl.rounds,
                                               pl.op_applications)
    _, (_, da, db) = _ssm_case()
    _close(_join(got[0]), da, SCAN_TOL, SCAN_TOL, "da")
    _close(_join(got[1]), db, SCAN_TOL, SCAN_TOL, "db")


def test_cp_scans_gradcheck_fp64():
    gen = torch.Generator().manual_seed(5)
    kw = {"generator": gen, "dtype": torch.float64}
    a = (torch.rand((3, 2, 4, 3), **kw) * 0.3 + 0.7).requires_grad_()
    b = torch.randn((3, 2, 4, 3), **kw).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, y: tcp.cp_ssm_scan(x, y, algorithm="123"), [a, b])
    w = (torch.rand((3, 1, 4, 2, 4, 1), **kw) * 0.3 + 0.7).requires_grad_()
    kv = torch.randn((3, 1, 4, 2, 4, 4), **kw).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, y: tcp.cp_wkv_scan(x, y, algorithm="two_op"), [w, kv])


def test_cp_scans_without_grad_launch_what_they_did():
    """Under ``torch.no_grad`` the cp scans keep no graph and give the
    values they gave with autograd."""
    (a, b, _), _ = _ssm_case()
    xs, ys = _split(a, 4), _split(b, 4)
    with torch.no_grad():
        h = tcp.cp_ssm_scan(xs, ys)
    assert h.grad_fn is None and not h.requires_grad
    assert torch.equal(h, tcp.cp_ssm_scan(xs, ys).detach())


# ---------------------------------------------------------------------------
# Model.loss under fsdp_sp, and remat "dots"
# ---------------------------------------------------------------------------

B, S = 2, 24


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@functools.cache
def _reference(name, **overrides):
    """The reference's smoke model on its (1, 1) mesh: params, batch,
    and (loss, grads) of ``jax.value_and_grad(model.loss)``."""
    cfg = rconfigs.get_smoke(name, **overrides)
    model = RModel(cfg, _mesh1())
    params = model.init_params(jax.random.PRNGKey(0))
    batch = {k: np.asarray(v)
             for k, v in ref_synthetic_batch(cfg, B, S, 0).items()}
    with jax.set_mesh(model.mesh):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(params, jax.tree.map(jnp.asarray,
                                                            batch))
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            jax.tree.map(np.asarray, grads))


def _port_loss(name, ranks, ref_params, batch, **overrides):
    """The port's loss and every gradient leaf on the reference's
    weights and batch."""
    cfg = tconfigs.get_smoke(name, **overrides)
    model = TModel(cfg, ranks, device="cpu")
    params = model.load_params(
        tparams.from_reference(ref_params, cfg, "cpu"), trainable=True)
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, _tree.leaves(params))


def _against_reference(got_loss, got_grads, want_loss, want_grads, what):
    np.testing.assert_allclose(float(got_loss.detach()), want_loss,
                               atol=ATOL, rtol=RTOL)
    paths = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_leaves_with_path(want_grads)]
    want = jax.tree.leaves(want_grads)
    assert len(got_grads) == len(want)
    for path, g, w in zip(paths, got_grads, want):
        assert tuple(g.shape) == w.shape, path
        _close(g.numpy(), w, GRAD_ATOL, GRAD_RTOL, f"{what} {path}")


FSDP_SP = [("rwkv6_1_6b", (1, 4), {}),
           ("qwen2_moe_a2_7b", (2, 4), {"capacity_factor": 16.0})]


@pytest.mark.parametrize("name,ranks,overrides", FSDP_SP)
def test_fsdp_sp_loss_grads_match_reference(name, ranks, overrides):
    """The sequence split over the model ranks (RWKV's wkv through
    ``cp_wkv_scan``, Qwen's MoE dispatch per shard) trains to the
    reference's single-device gradients; the cp carry runs forward and
    backward."""
    params, batch, want_loss, want_grads = _reference(name, **overrides)
    with tsa.use_cost_model(REFERENCE_PROFILE), \
            tsch.collect_stats() as st:
        loss, grads = _port_loss(name, ranks, params, batch,
                                 sharding_strategy="fsdp_sp", **overrides)
    _against_reference(loss, grads, want_loss, want_grads, name)
    cfg = tconfigs.get_smoke(name)
    if any(s.kind == "rwkv" for s in cfg.pattern()):
        # per layer: the carry in the forward, its remat recompute and
        # the reverse carry of the backward, planned as the reference
        # plans its (w_tot, s_final) carry under its constants
        H = cfg.d_model // 64
        tree = (jnp.zeros((B, H, 64, 1)), jnp.zeros((B, H, 64, 64)))
        pl = rsa.plan(rcp._carry_spec(rconfigs.get_smoke(name).scan_spec,
                                      None, "model"), ranks[1],
                      nbytes=rsa._tree_nbytes(tree))
        assert st.rounds == 3 * cfg.n_layers * pl.rounds


class _CountDots(TorchDispatchMode):
    """Counts the matrix products (``model.DOTS``) dispatched inside."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in DOTS
        return func(*args, **(kwargs or {}))


def _dots_in_backward(name, ranks, params, batch, **overrides):
    cfg = tconfigs.get_smoke(name, **overrides)
    model = TModel(cfg, ranks, device="cpu")
    tparams_ = model.load_params(
        tparams.from_reference(params, cfg, "cpu"), trainable=True)
    loss, _ = model.loss(tparams_, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    with _CountDots() as count:
        grads = torch.autograd.grad(loss, _tree.leaves(tparams_))
    return loss, grads, count.n


@pytest.mark.parametrize("name,ranks", [("rwkv6_1_6b", (1, 1)),
                                        ("rwkv6_1_6b", (1, 4)),
                                        ("jamba_1_5_large_398b", (1, 1)),
                                        ("qwen2_moe_a2_7b", (2, 4))])
def test_remat_dots_matches_reference_and_recomputes_no_product(name, ranks):
    """Policy "dots" against the reference's ``remat_policy="dots"``
    gradients; equal to policy "nothing" within 1e-6 of scale / 1e-5;
    its backward runs exactly the matrix products of a backward without
    remat, where "nothing" also recomputes the forward's."""
    over = {"capacity_factor": 16.0} if "moe" in name else {}
    if ranks != (1, 1):
        over["sharding_strategy"] = "fsdp_sp"
    params, batch, want_loss, want_grads = _reference(
        name, remat_policy="dots",
        **{k: v for k, v in over.items() if k == "capacity_factor"})
    runs = {}
    for policy, remat in (("dots", True), ("nothing", True),
                          ("nothing", False)):
        runs[policy, remat] = _dots_in_backward(
            name, ranks, params, batch, remat=remat, remat_policy=policy,
            **over)
    loss, grads, n_dots = runs["dots", True]
    _against_reference(loss, grads, want_loss, want_grads, name)
    _, grads_nothing, n_nothing = runs["nothing", True]
    for a, b in zip(grads, grads_nothing):
        _close(a.numpy(), b.numpy(), 1e-6, 1e-5)
    n_plain = runs["nothing", False][2]
    assert n_dots == n_plain < n_nothing, (n_dots, n_plain, n_nothing)
