"""The port's model stack against the JAX package's, on the CPU.

Weights come from the reference's ``Model.init_params(PRNGKey(0))`` and
reach the port through ``params.from_reference``; inputs are made from
a numpy seed and handed to both.  Every smoke config is fp32, so the
logits are held at the JAX package's own cross-mesh tolerance
(``tests/test_models.py``: atol 3e-4, rtol 3e-3): the two frameworks
sum the same products in other orders.  Each JAX reference is computed
once per module (a smoke forward takes seconds to trace here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.models import params as rparams
from repro.models.model import Model as RModel
from repro_torch import configs as tconfigs
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel

ATOL, RTOL = 3e-4, 3e-3
B, S = 2, 24
SERVED = ("rwkv6_1_6b", "qwen2_moe_a2_7b", "jamba_1_5_large_398b",
          "llama3_8b")


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@functools.cache
def _reference(name):
    """The reference model and its weights, made once per module."""
    cfg = rconfigs.get_smoke(name)
    model = RModel(cfg, _mesh1())
    return cfg, model, model.init_params(jax.random.PRNGKey(0))


def _port(name, ref_params, ranks=(1, 1)):
    cfg = tconfigs.get_smoke(name)
    model = TModel(cfg, ranks, device="cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    return model, model.load_params(tparams.from_reference(tree, cfg, "cpu"))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    prefix = None
    if cfg.frontend == "audio":
        tokens = None
        prefix = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        prefix = rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return tokens, prefix


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.fixture(scope="module", params=rconfigs.ARCHITECTURES)
def forward_case(request):
    name = request.param
    cfg, model, params = _reference(name)
    tokens, prefix = _inputs(cfg)
    with jax.set_mesh(model.mesh):
        logits, aux = jax.jit(model.forward)(params, _j(tokens), _j(prefix))
    return name, params, tokens, prefix, np.asarray(logits), np.asarray(aux)


def test_forward_matches_reference(forward_case):
    name, params, tokens, prefix, want, want_aux = forward_case
    model, tp = _port(name, params)
    got, aux = model.forward(tp, _t(tokens), _t(prefix))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux.numpy(), want_aux, atol=ATOL, rtol=RTOL)


def test_module_holds_the_reference_tree(forward_case):
    """The module's parameters are the tree, name for name, and calling
    with ``params=None`` uses them."""
    name, params, tokens, prefix, want, _ = forward_case
    model, tp = _port(name, params)
    names = {n for n, _ in model.named_parameters()}
    want_names = {f"top.{k}" for k in params["top"]} | {
        f"blocks.{j}.{k}" for j, b in enumerate(params["blocks"]) for k in b}
    assert names == want_names
    for j, block in enumerate(params["blocks"]):
        for k, v in block.items():
            assert tuple(model.blocks[j][k].shape) == v.shape
    got, _ = model(None, _t(tokens), _t(prefix))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module", params=SERVED)
def serve_case(request):
    """JAX: prefill 10 prompt tokens into a cache of 14, then 3 decode
    steps; the logits of each step and the caches after the prefill."""
    name = request.param
    cfg, model, params = _reference(name)
    P, G = 10, 4
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab, (B, P)).astype(np.int32)
    prefill = jax.jit(lambda p, c, t: model.serve_step(
        p, c, t, 0, last_only=True))
    decode = jax.jit(model.decode_step)
    steps = []
    with jax.set_mesh(model.mesh):
        cache = model.init_cache(B, P + G)
        logits, cache = prefill(params, cache, jnp.asarray(prompts))
        prefill_cache = jax.tree.map(np.asarray, cache)
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        feed = [np.asarray(tok)]
        for i in range(G - 1):
            logits, cache = decode(params, cache, tok[:, None], P + i)
            steps.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            feed.append(np.asarray(tok))
    return name, params, prompts, steps, feed, prefill_cache


def test_serve_step_matches_reference(serve_case):
    """Prefill into the cache, then decode steps fed the reference's own
    tokens; logits and the prefill's caches within tolerance."""
    name, params, prompts, steps, feed, want_cache = serve_case
    model, tp = _port(name, params)
    P = prompts.shape[1]
    cache = model.init_cache(B, P + len(steps))
    logits, cache = model.serve_step(tp, cache, torch.from_numpy(prompts), 0,
                                     last_only=True)
    assert logits.shape == steps[0].shape
    np.testing.assert_allclose(logits.numpy(), steps[0], atol=ATOL, rtol=RTOL)
    got_cache = jax.tree.map(lambda t: t.numpy().copy(), cache)
    for got, want in zip(jax.tree.leaves(got_cache),
                         jax.tree.leaves(want_cache)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for i, want in enumerate(steps[1:]):
        tok = torch.from_numpy(feed[i][:, None].copy())
        logits, cache = model.decode_step(tp, cache, tok, P + i)
        np.testing.assert_allclose(logits.numpy(), want, atol=ATOL,
                                   rtol=RTOL)


def test_prefill_equals_forward(serve_case):
    """The cache path's last-position logits are the full forward's."""
    name, params, prompts, _, _, _ = serve_case
    model, tp = _port(name, params)
    full, _ = model.forward(tp, torch.from_numpy(prompts))
    cache = model.init_cache(B, prompts.shape[1] + 2)
    last, _ = model.serve_step(tp, cache, torch.from_numpy(prompts), 0,
                               last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", rconfigs.ARCHITECTURES)
def test_param_counts_match_reference(name):
    t, r = tconfigs.get(name), rconfigs.get(name)
    assert t.param_count() == rparams.count_params(r)
    assert t.active_param_count() == rparams.count_params(r, active_only=True)
    for seq, training in ((1, False), (4096, True)):
        assert t.model_flops_per_token(seq, training) == \
            r.model_flops_per_token(seq, training)
    assert tparams.logical_axes(t) == rparams.logical_axes(r)


@pytest.mark.parametrize("name", ("rwkv6_1_6b", "jamba_1_5_large_398b",
                                  "qwen2_moe_a2_7b", "gemma2_9b"))
def test_init_params_kinds_and_shapes(name):
    """The port's initialiser: the reference's shapes, dtypes and init
    kinds (zeros, ones, log(1..d_state) for a_log, scaled normals)."""
    cfg = tconfigs.get_smoke(name)
    tree = tparams.init_params(cfg, 3, "cpu")
    ref = rparams.abstract_params(rconfigs.get_smoke(name))
    shapes = jax.tree.map(lambda s: s.shape, ref)
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == shapes
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(tree))
    again = tparams.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        assert torch.equal(a, b)
    for j, (spec, block) in enumerate(zip(cfg.pattern(), tree["blocks"])):
        defs = tparams.block_defs(cfg, spec)
        for k, v in block.items():
            kind = defs[k].init
            if k == "a_log":
                want = torch.log(torch.arange(1, cfg.d_state + 1.0))
                assert torch.equal(v, want.expand_as(v))
            elif kind == "zeros":
                assert not v.any()
            elif kind == "ones":
                assert bool((v == 1).all())
            else:
                fan = defs[k].shape[-2] if v.dim() >= 3 else defs[k].shape[-1]
                scale = 0.02 if kind == "normal" else fan ** -0.5
                assert abs(float(v.std()) / scale - 1) < 0.25, (k, scale)


def test_from_reference_checks_shapes():
    cfg = tconfigs.get_smoke("llama3_8b")
    tree = jax.tree.map(lambda t: t.numpy(),
                        tparams.init_params(cfg, 0, "cpu"))
    tree["top"]["final_norm"] = tree["top"]["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        tparams.from_reference(tree, cfg, "cpu")


def test_vocab_and_expert_padding():
    for name in rconfigs.ARCHITECTURES:
        t, r = tconfigs.get(name), rconfigs.get(name)
        assert tparams.vocab_padded(t) == rparams.vocab_padded(r)
        assert tparams.experts_padded(t) == rparams.experts_padded(r)


def test_serve_step_refuses_a_cache_too_short():
    cfg = tconfigs.get_smoke("llama3_8b")
    model = TModel(cfg, (1, 1), device="cpu")
    params = model.init_params(0)
    cache = model.init_cache(1, 4)
    with pytest.raises(ValueError, match="exceed"):
        model.serve_step(params, cache, torch.zeros((1, 5), dtype=torch.int32),
                         0)
