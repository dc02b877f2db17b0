"""The port's training path against the JAX package's, on the CPU.

The backward of the scans: ``scan_engine.AffineChunkFn`` (on the CPU
its backward is ``affine_chunk_bwd_plain``) against ``jax.vjp`` of the
reference's ``ssm_scan_chunked`` (inclusive, r = 1) and
``wkv_scan_chunked`` (exclusive, the decay broadcast over r = hd).
Both are fp32 recurrences summed in other orders (the reference's
log-depth associative scan), so they are held at 2e-4 of the
gradient's scale, the JAX package's own tolerance for its wkv carry
(``tests/test_context_parallel.py``).  ``torch.autograd.gradcheck``
holds the plain backward to finite differences in fp64.

The models: ``Model.loss`` and every gradient leaf against
``jax.value_and_grad(model.loss)`` for four smoke configs, weights from
the reference's ``init_params`` through ``params.from_reference``.
The loss at the forward's cross-mesh tolerance (``tests/test_models.py``:
atol 3e-4, rtol 3e-3); a gradient leaf at atol 1e-3 of its largest
entry and rtol 1e-2: the two frameworks sum the same products in other
orders through every layer, and a backward sums once more (measured:
within about 1e-4 of the leaf's scale).  One ``make_train_step`` at
the peak learning rate against the reference's step: the moments at
the gradients' tolerance.  A parameter moves by lr·(delta + 0.1·p),
with delta = g/(|g| + 1e-8) on the first step: about ±1, except where
|g| is near the gradients' rounding, where delta follows that rounding.
So every parameter within 0.1·lr of the reference's, and all but 1 in
1000 within 1e-3·lr (measured: at most 0.047·lr, in 316 of 1.9 M
entries for Jamba, 12 of 0.29 M for Qwen).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.data.pipeline import synthetic_batch as ref_synthetic_batch
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.mamba import ssm_scan_chunked as ref_ssm
from repro.models.model import Model as RModel
from repro.models.rwkv import wkv_scan_chunked as ref_wkv
from repro.optim import adamw as radamw
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch import device as tdev
from repro_torch.kernels import scan_engine as se
from repro_torch.launch.steps import make_train_step
from repro_torch.models import context_parallel as tcp
from repro_torch.models import mamba as tmamba
from repro_torch.models import params as tparams
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import Model as TModel
from repro_torch.optim import adamw as tadamw

SCAN_TOL = 2e-4
ATOL, RTOL = 3e-4, 3e-3
GRAD_ATOL, GRAD_RTOL = 1e-3, 1e-2
B, S = 2, 24
TRAINED = ("rwkv6_1_6b", "jamba_1_5_large_398b", "qwen2_moe_a2_7b",
           "llama3_8b")


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _close(got, want, atol, rtol, what=""):
    """got within atol·max|want| + rtol·|want| of want."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, atol=atol * max(scale, 1e-12),
                               rtol=rtol, err_msg=what)


# ---------------------------------------------------------------------------
# the scans' backward
# ---------------------------------------------------------------------------


def _ssm_case(S_, seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, S_, 3, 4)
    a = rng.uniform(0.7, 1.0, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    return (a, b, h0), (rng.standard_normal(shape).astype(np.float32),
                        rng.standard_normal((2, 3, 4)).astype(np.float32))


def _wkv_case(S_, seed=0):
    rng = np.random.default_rng(seed)
    H, hd = 2, 8
    w = rng.uniform(0.8, 1.0, (2, S_, H, hd, 1)).astype(np.float32)
    kv = (rng.standard_normal((2, S_, H, hd, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((2, H, hd, hd)).astype(np.float32)
    return (w, kv, s0), (
        rng.standard_normal((2, S_, H, hd, hd)).astype(np.float32),
        rng.standard_normal((2, H, hd, hd)).astype(np.float32))


SCANS = {"ssm": (_ssm_case, ref_ssm, tmamba.ssm_scan_chunked),
         "wkv": (_wkv_case, ref_wkv, trwkv.wkv_scan_chunked)}


@pytest.mark.parametrize("S_", [64, 20, 1])
@pytest.mark.parametrize("kind", sorted(SCANS))
def test_scan_backward_matches_jax_vjp(kind, S_):
    """gY, gH and h0 != 0; the reference's S = 64 walks two chunks."""
    make, ref, port = SCANS[kind]
    inputs, cot = make(S_)
    out, vjp = jax.vjp(ref, *map(jnp.asarray, inputs))
    want = vjp(tuple(map(jnp.asarray, cot)))
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    before = se.affine_chunk_bwd.launches
    got_out = port(*ts)
    for g, w in zip(got_out, out):
        _close(g.detach().numpy(), w, SCAN_TOL, SCAN_TOL)
    got = torch.autograd.grad(got_out, ts, [torch.from_numpy(c) for c in cot])
    assert se.affine_chunk_bwd.launches == before  # the CPU: plain version
    for name, g, w in zip(("a", "b", "h0"), got, want):
        assert g.shape == w.shape, name
        _close(g.numpy(), w, SCAN_TOL, SCAN_TOL, f"{kind} d{name}")


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("r", [1, 4])
def test_plain_backward_gradcheck(r, exclusive):
    gen = torch.Generator().manual_seed(r + 2 * exclusive)
    G, T, D = 2, 5, 8
    a = torch.rand((G, T, D // r), generator=gen, dtype=torch.float64)
    b = torch.randn((G, T, D), generator=gen, dtype=torch.float64)
    h0 = torch.randn((G, D), generator=gen, dtype=torch.float64)
    args = [x.requires_grad_() for x in (a, b, h0)]
    assert torch.autograd.gradcheck(
        lambda a_, b_, h_: se.affine_chunk_h(a_, b_, h_, exclusive=exclusive),
        args)


@pytest.mark.parametrize("r", [2, 32, 64])
def test_tree_sum_is_the_shuffle_order(r):
    """da's sum over r columns, as the kernel's lanes add it: for r > 32
    a lane's r/32 columns in order, then xor shuffles over the lanes;
    lane 0 keeps the sum.  The plain version must give its bits."""
    rng = np.random.default_rng(r)
    x = (rng.standard_normal((3, r))
         * 10.0 ** rng.integers(-3, 4, (3, r))).astype(np.float32)
    lanes = min(r, 32)
    cols = np.array([x[:, j::32] if r > 32 else x[:, j:j + 1]
                     for j in range(lanes)])  # (lanes, 3, m)
    part = cols[..., 0]
    for k in range(1, cols.shape[-1]):
        part = (part + cols[..., k]).astype(np.float32)
    off = lanes // 2
    while off:
        part = (part + part[np.arange(lanes) ^ off]).astype(np.float32)
        off //= 2
    got = se._tree_sum(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, part[0])


def test_plain_backward_takes_any_broadcast():
    """An r the kernel does not take (3, 96) still has a plain backward,
    its sum by ``torch.sum``; held to autograd through the plain
    forward in fp64."""
    for r in (3, 96):
        gen = torch.Generator().manual_seed(r)
        a = torch.rand((1, 4, 2), generator=gen, dtype=torch.float64)
        b = torch.randn((1, 4, 2 * r), generator=gen, dtype=torch.float64)
        h0 = torch.randn((1, 2 * r), generator=gen, dtype=torch.float64)
        assert not se.bwd_serves(r)
        assert torch.autograd.gradcheck(
            lambda a_, b_, h_: se.affine_chunk_h(a_, b_, h_, exclusive=True),
            [x.requires_grad_() for x in (a, b, h0)])


def test_affine_chunk_without_the_function_refuses_grad():
    a = torch.rand(1, 4, 3, requires_grad=True)
    b = torch.randn(1, 4, 3)
    with pytest.raises(RuntimeError, match="no gradient"):
        se.affine_chunk(a, b, a_final=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        se.affine_chunk_summary(a, b)
    with torch.no_grad():  # serving: no autograd, no refusal
        se.affine_chunk_summary(a, b)


def test_cp_scans_take_grad():
    """The cp scans train: the gradient of a split sequence is the
    sequential scan's (``tests/test_torch_cp_train.py`` holds them to the
    reference); without autograd they still run."""
    inputs, _ = _ssm_case(8)
    a, b = (torch.from_numpy(x).reshape(2, 1, 8, 3, 4).requires_grad_()
            for x in inputs[:2])
    ga, gb = torch.autograd.grad(tcp.cp_ssm_scan(a, b).sum(), [a, b])
    h, _ = se.affine_chunk_h(a.reshape(1, 16, 12), b.reshape(1, 16, 12),
                             torch.zeros(1, 12))  # the unsplit sequence
    wa, wb = torch.autograd.grad(h.sum(), [a, b])
    _close(ga.numpy(), wa.numpy(), SCAN_TOL, SCAN_TOL, "da")
    _close(gb.numpy(), wb.numpy(), SCAN_TOL, SCAN_TOL, "db")
    (w, kv, _), _ = _wkv_case(8)
    w = torch.from_numpy(w).reshape(2, 2, 4, 2, 8, 1).requires_grad_()
    kv = torch.from_numpy(kv).reshape(2, 2, 4, 2, 8, 8)
    (gw,) = torch.autograd.grad(tcp.cp_wkv_scan(w, kv).sum(), [w])
    # w_t scales S_{t-1}: zero before the first token, unread after the last
    assert gw.shape == w.shape and bool(gw[:, :, 1:-1].abs().gt(0).all())
    with torch.no_grad():
        assert tcp.cp_wkv_scan(w, kv).shape == kv.shape


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------


@functools.cache
def _reference(name):
    cfg = rconfigs.get_smoke(name)
    model = RModel(cfg, _mesh1())
    return cfg, model, model.init_params(jax.random.PRNGKey(0))


def _batch(cfg, seed=0):
    return {k: np.asarray(v)
            for k, v in ref_synthetic_batch(cfg, B, S, seed).items()}


def _port(name, ref_params, **overrides):
    cfg = tconfigs.get_smoke(name, **overrides)
    model = TModel(cfg, (1, 1), device="cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    params = model.load_params(tparams.from_reference(tree, cfg, "cpu"),
                               trainable=True)
    return model, params


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def _reference_grads(name):
    cfg, model, params = _reference(name)
    batch = _batch(cfg)
    with jax.set_mesh(model.mesh):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(params, jax.tree.map(jnp.asarray,
                                                            batch))
    return (batch, float(loss), jax.tree.map(np.asarray, metrics),
            jax.tree.map(np.asarray, grads))


def _paths(tree):
    return [jax.tree_util.keystr(kp)
            for kp, _ in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", TRAINED)
def test_loss_and_grads_match_reference(name):
    _, _, ref_params = _reference(name)
    batch, want_loss, want_metrics, want_grads = _reference_grads(name)
    model, params = _port(name, ref_params)
    loss, metrics = model.loss(params, _tbatch(batch))
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=ATOL,
                               rtol=RTOL)
    for k in ("ce", "load_balance", "dropped"):
        np.testing.assert_allclose(float(metrics[k].detach()), want_metrics[k],
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    leaves = _tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = jax.tree.leaves(want_grads)
    assert len(grads) == len(want)
    for path, g, w in zip(_paths(want_grads), grads, want):
        assert g is not None, path
        assert tuple(g.shape) == w.shape, path
        _close(g.numpy(), w, GRAD_ATOL, GRAD_RTOL, f"{name} {path}")


def test_scan_gradients_reach_upstream():
    """The wkv scan's inputs train: the decay and key projections of
    every RWKV layer get nonzero gradients (an output written by a
    kernel without a backward would leave them at zero)."""
    _, _, ref_params = _reference("rwkv6_1_6b")
    batch, *_ = _reference_grads("rwkv6_1_6b")
    model, params = _port("rwkv6_1_6b", ref_params)
    loss, _ = model.loss(params, _tbatch(batch))
    blk = params["blocks"][0]
    g_decay, g_k = torch.autograd.grad(loss, [blk["w_decay"], blk["wk"]])
    for g in (g_decay, g_k):
        assert bool((g.reshape(g.shape[0], -1).abs().amax(dim=1) > 0).all())


@pytest.mark.parametrize("name", ["rwkv6_1_6b", "jamba_1_5_large_398b"])
def test_remat_on_and_off_give_equal_gradients(name):
    """Checkpointed repeats recompute the same forward on the CPU; the
    gradients agree to fp32 rounding (autograd may add a stacked leaf's
    per-repeat slices in another order)."""
    _, _, ref_params = _reference(name)
    batch, *_ = _reference_grads(name)
    out = []
    for remat in (True, False):
        model, params = _port(name, ref_params, remat=remat)
        loss, _ = model.loss(params, _tbatch(batch))
        out.append((loss, torch.autograd.grad(loss, _tree.leaves(params))))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        _close(a.numpy(), b.numpy(), 1e-6, 1e-5)


def test_remat_policy_dots_gives_the_gradients():
    """Policy "dots" trains to policy "nothing"'s gradients
    (``tests/test_torch_cp_train.py`` holds it to the reference's and
    counts its recomputed products); without autograd nothing is
    checkpointed."""
    _, _, ref_params = _reference("rwkv6_1_6b")
    batch, *_ = _reference_grads("rwkv6_1_6b")
    out = []
    for policy in ("dots", "nothing"):
        model, params = _port("rwkv6_1_6b", ref_params, remat_policy=policy)
        loss, _ = model.loss(params, _tbatch(batch))
        out.append((loss, torch.autograd.grad(loss, _tree.leaves(params))))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        _close(a.numpy(), b.numpy(), 1e-6, 1e-5)
    with torch.no_grad():  # no autograd: no remat
        assert torch.equal(model.loss(params, _tbatch(batch))[0], l2)


# ---------------------------------------------------------------------------
# AdamW and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_on_the_same_grads(dtype):
    """The same parameters, gradients and state through both updates,
    three steps: the moments within 1 ulp-scale of fp32 (XLA may fuse
    a product into an FMA), the parameters to one unit of their dtype
    in the last place."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    shapes = {"a": (5, 7), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(npdt) for k, s in
              shapes.items()}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: tdev.leaf_to_torch(v, "cpu")
          for k, v in params.items()}
    jst, tst = radamw.adamw_init(jp), tadamw.adamw_init(tp)
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * 0.1).astype(npdt)
                 for k, s in shapes.items()}
        jp, jst = radamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                      jst, lr=1e-2)
        tp, tst = tadamw.adamw_update(
            tp, {k: tdev.leaf_to_torch(v, "cpu")
                 for k, v in grads.items()}, tst, lr=1e-2)
    assert int(tst.step) == int(jst.step) == 3
    for k in shapes:
        np.testing.assert_allclose(tst.mu[k].numpy(), np.asarray(jst.mu[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tst.nu[k].numpy(), np.asarray(jst.nu[k]),
                                   rtol=1e-6, atol=1e-12)
        want = np.asarray(jp[k]).astype(np.float32)
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23
        np.testing.assert_allclose(tp[k].float().numpy(), want,
                                   rtol=ulp, atol=0)


def test_schedule_and_clip_match_reference():
    for step in (0, 1, 5, 10, 55, 100, 120):
        want = float(radamw.cosine_lr(jnp.int32(step), peak=3e-3, warmup=10,
                                      total=100))
        got = float(tadamw.cosine_lr(step, peak=3e-3, warmup=10, total=100))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    rng = np.random.default_rng(4)
    grads = {"x": rng.standard_normal((4, 5)).astype(np.float32),
             "y": (rng.standard_normal(7) * 3).astype(np.float32)}
    jg, jn = radamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tg, tn = tadamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=1e-7)


LR, WARMUP = 1e-3, 4


@pytest.mark.parametrize("name", ["rwkv6_1_6b", "qwen2_moe_a2_7b"])
def test_train_step_matches_reference(name):
    """One step at the peak learning rate (step = warmup): metrics,
    moments and parameters against the reference's jitted step."""
    cfg, model, ref_params = _reference(name)
    batch = _batch(cfg)
    ref_step = jax.jit(ref_make_train_step(cfg, model.mesh, lr_peak=LR,
                                           warmup=WARMUP, total_steps=20))
    with jax.set_mesh(model.mesh):
        want_p, want_opt, want_m = ref_step(
            ref_params, radamw.adamw_init(ref_params),
            jax.tree.map(jnp.asarray, batch), jnp.int32(WARMUP))
    tmodel, params = _port(name, ref_params)
    step_fn = make_train_step(tmodel.cfg, (1, 1), lr_peak=LR, warmup=WARMUP,
                              total_steps=20, device="cpu")
    got_p, got_opt, got_m = step_fn(params, tadamw.adamw_init(params),
                                    _tbatch(batch), WARMUP)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-7)
    assert int(got_opt.step) == int(want_opt.step) == 1
    # mu is 0.1·g; nu is 0.05·g², whose relative error is twice g's
    for part, k in (("mu", 1), ("nu", 2)):
        want = getattr(want_opt, part)
        got = _tree.leaves(getattr(got_opt, part))
        for path, g, w in zip(_paths(want), got, jax.tree.leaves(want)):
            _close(g.numpy(), np.asarray(w), k * GRAD_ATOL, k * GRAD_RTOL,
                   f"{part} {path}")
    off = far = total = 0
    for path, g, w in zip(_paths(want_p), _tree.leaves(got_p),
                          jax.tree.leaves(want_p)):
        d = np.abs(g.detach().numpy() - np.asarray(w)) / LR
        assert float(d.max()) <= 0.1, f"param {path}: {float(d.max())}·lr"
        off, far, total = off + int((d > 1e-3).sum()), max(far, d.max()), \
            total + d.size
    assert off <= 1e-3 * total, (off, total, far)


def test_train_steps_lower_the_loss():
    """Eight steps on one batch lower the loss (the reference's
    ``tests/test_models.py`` check), through the scans' backward."""
    _, _, ref_params = _reference("rwkv6_1_6b")
    batch, *_ = _reference_grads("rwkv6_1_6b")
    model, params = _port("rwkv6_1_6b", ref_params)
    step_fn = make_train_step(model.cfg, lr_peak=3e-3, warmup=1,
                              total_steps=100, model=model)
    opt = tadamw.adamw_init(params)
    losses = []
    for step in range(8):
        params, opt, m = step_fn(params, opt, _tbatch(batch), step + 1)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
