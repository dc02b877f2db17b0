"""RWKV6 and Mamba served with their mixers split over the "model"
processes, on a 4-process gloo pool on the CPU, against the JAX package
and the stacked port.

Process k of the pool is mesh rank (i, j) = divmod(k, tp) of a (1, 4)
or (2, 2) grid.  Where the "tp" rule table splits them over "model" it
holds model rank j's share (``params.shard_params``): of an RWKV6 layer
its wkv heads (the r, k, v, g and decay columns, decay_bias, bonus_u,
wo's rows, its heads of the state) and its d_ff/tp of the channel mix
(cm_wk's columns, cm_wv's rows), ``cm_wr`` whole; of a Mamba mixer its
d_inner/tp channels (x_in's and z's columns of ``in_proj``, the conv,
x_proj's, A's and out_proj's rows, dt_proj's columns, its part of the
conv and SSM caches).  RWKV6's wo and cm_wv and Mamba's x_proj and
out_proj products are partials, each summed by one
``SPMDExecutor.all_reduce`` over "model".

Held against the stacked port at the same ranks, which computes the
same shares on one device and sums them in the same order, tokens,
logits, a mixer's output and its cache are equal bit for bit (both on
one thread).  Against the JAX package on one CPU device, on the same
weights, they agree within the cross-framework fp32 tolerance ATOL,
RTOL and the greedy tokens are equal.  The stock RWKV6 SMOKE has 2 wkv
heads, which do not split over 4 processes: the served RWKV6 here has
4 (``RWKV4``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.models import mamba as rmamba
from repro.models.model import Model as RModel
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import mamba as tmamba
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.models.moe import held_rows
from repro_torch.models.shards import WHOLE, StackedShards
from test_torch_moe_procs import (LAYOUTS, _mesh, _one_thread, pool,
                                  pool4)  # noqa: F401

ATOL, RTOL = 3e-4, 3e-3  # fp32 smoke logits, JAX against the port
RWKV = "rwkv6_1_6b"
RWKV4 = {"d_model": 256, "n_heads": 4, "n_kv_heads": 4}  # 4 wkv heads
JAMBA = "jamba_1_5_large_398b"
SB, SP, SG = 4, 8, 4  # requests, prompt tokens, generated tokens
MB, MP, MD = 4, 8, 3  # the Mamba mixer's rows, prefill, decode steps


@functools.cache
def _reference():
    """The JAX package's 4-head RWKV6 SMOKE on one CPU device: its
    weights from PRNGKey(0) as numpy, the served tokens of its prefill
    and greedy decode and the prefill's last logits, on
    ``serve.prompts_for``'s prompts."""
    cfg = rconfigs.get_smoke(RWKV, **RWKV4)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    model = RModel(cfg, mesh)
    params = model.init_params(jax.random.PRNGKey(0))
    prompts = tserve.prompts_for(tconfigs.get_smoke(RWKV, **RWKV4), SB, SP,
                                 0)
    prefill = jax.jit(lambda p, c, t: model.serve_step(
        p, c, t, 0, last_only=True))
    decode = jax.jit(model.decode_step)
    with jax.set_mesh(mesh):
        cache = model.init_cache(SB, SP + SG)
        logits, cache = prefill(params, cache, jnp.asarray(prompts))
        first = np.asarray(logits[:, -1])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out = [tok]
        for i in range(SG - 1):
            logits, cache = decode(params, cache, tok[:, None], SP + i)
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            out.append(tok)
    return (jax.tree.map(np.asarray, params),
            np.stack([np.asarray(t) for t in out], axis=1), first)


def _stacked(name, over, ranks, weights=None):
    """The stacked port at ``ranks`` on ``weights`` (the JAX package's
    tree as numpy; None: ``init_params(0)``), on one thread as the
    pool's processes run: its served tokens and prefill logits, and its
    forward's logits."""
    cfg = tconfigs.get_smoke(name, **over)
    model = TModel(cfg, ranks, device="cpu")
    tree = tparams.init_params(cfg, 0, "cpu") if weights is None \
        else tparams.from_reference(weights, cfg, "cpu")
    params = model.load_params(tree)
    assert isinstance(model.shards, StackedShards)
    prompts = tserve.prompts_for(cfg, SB, SP, 0)
    with _one_thread():
        res = tserve.serve_loop(model, params, prompts, SG)
        logits, _ = model.forward(params, torch.from_numpy(prompts))
    return res.tokens, res.prefill_logits.numpy(), logits.numpy()


def _share_bytes(cfg, ranks) -> int:
    """A process's dense bytes, counted from the configuration alone:
    a leaf split over "model" holds 1/tp of its elements, the kv heads
    max(1, n_kv/tp) of n_kv, every other leaf whole, and so does
    RWKV6's ``cm_wr``; then a leaf with an "embed" dim that the n_data
    data ranks divide holds 1/n_data of that (FSDP)."""
    n_data, tp = ranks
    kv = max(1, cfg.n_kv_heads // tp) / cfg.n_kv_heads
    size = tparams.torch_dtype(cfg).itemsize
    total = 0
    for path, d, stacked in tparams._iter_defs(cfg):
        if d.routed_expert:
            continue
        n = float(np.prod(d.shape)) * (cfg.n_repeats if stacked else 1)
        if "kv_heads" in d.axes:
            n *= kv
        elif path[-1] != "cm_wr" and any(
                a in ("heads", "mlp", "vocab", "d_inner") for a in d.axes):
            n /= tp
        if "embed" in d.axes and d.shape[d.axes.index("embed")] % n_data \
                == 0:
            n /= n_data
        total += n
    return int(total) * size


def _all_reduces(cfg, calls: int) -> int:
    """A process's all-reduces over ``calls`` model calls: the
    embedding's, and each RWKV6 layer's wo and cm_wv."""
    return calls * (1 + 2 * len(cfg.pattern()) * cfg.n_repeats)


def test_rwkv_serve_matches_reference_and_stacked(pool):
    """The 4-head RWKV6 SMOKE served over the pool, its wkv heads and
    channel mix split, on the JAX package's weights: the stacked port's
    tokens and prefill logits bit for bit, the JAX package's prefill
    logits within ATOL, RTOL and its greedy tokens; each process holds
    its share of the bytes and makes one all-reduce for the embedding
    and two a layer in each of the SG calls."""
    weights, ref_tokens, ref_logits = _reference()
    want_tokens, want_logits, _ = _stacked(RWKV, RWKV4, pool.ranks, weights)
    got = tserve.serve_procs(pool, arch=RWKV, smoke=True, batch=SB,
                             prompt_len=SP, gen=SG, seed=0,
                             ranks=pool.ranks, weights=weights, **RWKV4)
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    assert got["prefill_logits"].tobytes() == want_logits.tobytes()
    np.testing.assert_array_equal(got["tokens"], ref_tokens)
    np.testing.assert_allclose(got["prefill_logits"], ref_logits,
                               atol=ATOL, rtol=RTOL)
    cfg = tconfigs.get_smoke(RWKV, **RWKV4)
    held = got["result"].outputs[3]
    mesh = make_host_mesh(*pool.ranks)
    assert (held[:, 0] == _share_bytes(cfg, pool.ranks)).all()
    assert [h[0] for h in held] == [tparams.share_nbytes(cfg, mesh, k)[
        "dense"] for k in range(pool.nprocs)]
    tr = got["result"].transport
    assert tr["all_reduce"] == pool.nprocs * _all_reduces(cfg, SG) == \
        pool.nprocs * SG * tparams.all_reduces(cfg, tparams.plan_split(
            cfg, mesh))
    assert tr["staged_copies"] == 0


def test_rwkv_forward_over_processes_is_the_stacked_forward(pool):
    """``Model.forward`` of the split RWKV6 over the pool: each
    process's (B_k, S, vocab_padded) logits are the stacked forward's
    rows bit for bit, and the JAX package's last position within ATOL,
    RTOL."""
    weights, _, ref_logits = _reference()
    _, _, want = _stacked(RWKV, RWKV4, pool.ranks, weights)
    res = pool.call("serve", None, arch=RWKV, smoke=True, batch=SB,
                    prompt_len=SP, gen=1, ranks=pool.ranks, forward=True,
                    weights=weights, mesh=_mesh(pool.ranks), **RWKV4)
    mesh = make_host_mesh(*pool.ranks)
    for k in range(pool.nprocs):
        rows = held_rows(SB, mesh, k)
        logits = res.outputs[0][k]
        assert logits.tobytes() == want[rows].tobytes()
        np.testing.assert_allclose(logits[:, -1], ref_logits[rows],
                                   atol=ATOL, rtol=RTOL)


def _mixer_x(cfg):
    return np.random.default_rng(29).standard_normal(
        (MB, MP + MD, cfg.d_model)).astype(np.float32)


def _mixer_run(cfg, p, x, cache, shards):
    """``mamba_block`` on x's first MP positions into ``cache``, then
    a decode step a position: y (B, MP + MD, d)."""
    ys = [tmamba.mamba_block(cfg, p, x[:, :MP], cache=cache,
                             shards=shards)[0]]
    for t in range(MP, MP + MD):
        ys.append(tmamba.mamba_block(cfg, p, x[:, t:t + 1], cache=cache,
                                     shards=shards)[0])
    return torch.cat(ys, dim=1)


@functools.cache
def _mixer_reference():
    """The JAX package's ``mamba_block`` of Jamba SMOKE on one CPU
    device, on the port's weights from seed 0 (as numpy) and
    ``_mixer_x``: the prefill then the decode steps, y and the cache."""
    cfg = rconfigs.get_smoke(JAMBA)
    p = {k: jnp.asarray(v.numpy()) for k, v in tparams.init_mamba_mixer(
        tconfigs.get_smoke(JAMBA), 0, "cpu").items()}
    x = jnp.asarray(_mixer_x(cfg))
    cache = rmamba.init_mamba_cache(cfg, MB, jnp.float32)
    y, cache = rmamba.mamba_block(cfg, p, x[:, :MP], cache=cache)
    ys = [y]
    for t in range(MP, MP + MD):
        y, cache = rmamba.mamba_block(cfg, p, x[:, t:t + 1], cache=cache)
        ys.append(y)
    return (np.asarray(jnp.concatenate(ys, axis=1)),
            np.asarray(cache["conv"]), np.asarray(cache["h"]))


def test_mamba_mixer_over_processes_is_the_stacked_layer(pool):
    """Jamba SMOKE's Mamba mixer through the pool's ``mamba_block``
    entry, each process its d_inner/tp channels: a prefill into its
    cache share, then decode steps.  y and each process's conv and h
    are the stacked layer's (all tp shares on one device) bit for bit,
    and the JAX package's ``mamba_block`` on the same weights and inputs
    within ATOL, RTOL; two all-reduces a call; each process holds its
    share of the mixer's bytes."""
    cfg = tconfigs.get_smoke(JAMBA)
    x = _mixer_x(cfg)
    ranks, tp = pool.ranks, pool.ranks[1]
    mesh = make_host_mesh(*ranks)
    res = pool.call("mamba_block", np.stack([x] * pool.nprocs), arch=JAMBA,
                    smoke=True, ranks=ranks, prefill=MP, mesh=_mesh(ranks))
    whole = tparams.init_mamba_mixer(cfg, 0, "cpu")
    p = tparams.stack_layer(whole, cfg, mesh, "mamba")
    cache = tmamba.init_mamba_cache(cfg, MB, torch.float32, "cpu",
                                    d_inner=cfg.d_inner // tp)
    cache = {k: v.expand(tp, *v.shape).contiguous() for k, v in cache.items()}
    with _one_thread():
        y = _mixer_run(cfg, p, torch.from_numpy(x), cache, StackedShards(tp))
    ref_y, ref_conv, ref_h = _mixer_reference()
    di = cfg.d_inner // tp
    got_y, got_conv, got_h, held = res.outputs
    for k in range(pool.nprocs):
        rows, j = held_rows(MB, mesh, k), k % tp
        assert got_y[k].tobytes() == y[rows].numpy().tobytes(), k
        assert got_conv[k].tobytes() == cache["conv"][j][rows].numpy() \
            .tobytes(), k
        assert got_h[k].tobytes() == cache["h"][j][rows].numpy() \
            .tobytes(), k
        np.testing.assert_allclose(got_y[k], ref_y[rows], atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got_conv[k],
                                   ref_conv[rows, :, j * di:(j + 1) * di],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got_h[k], ref_h[rows, j * di:(j + 1) * di],
                                   atol=ATOL, rtol=RTOL)
    total = sum(v.numel() * v.element_size() for v in whole.values())
    norm = whole["norm1"].numel() * whole["norm1"].element_size()
    assert (held[:, 0] == (total - norm) // tp + norm).all()
    assert res.transport["all_reduce"] == pool.nprocs * 2 * (1 + MD)


def test_jamba_serve_over_processes_is_the_stacked_run(pool4):
    """Jamba SMOKE whole over the pool at (1, 4), its attention, dense
    FFN and Mamba mixers split and its experts held apart: the stacked
    port's tokens, prefill logits and forward logits bit for bit."""
    ranks = (1, 4)
    want_tokens, want_logits, want = _stacked(JAMBA, {}, ranks)
    got = tserve.serve_procs(pool4, arch=JAMBA, smoke=True, batch=SB,
                             prompt_len=SP, gen=SG, seed=0, ranks=ranks)
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    assert got["prefill_logits"].tobytes() == want_logits.tobytes()
    cfg = tconfigs.get_smoke(JAMBA)
    split = tparams.plan_split(cfg, make_host_mesh(*ranks))
    assert got["result"].transport["all_reduce"] == \
        4 * SG * tparams.all_reduces(cfg, split)
    res = pool4.call("serve", None, arch=JAMBA, smoke=True, batch=SB,
                     prompt_len=SP, gen=1, ranks=ranks, forward=True,
                     mesh=_mesh(ranks))
    for k in range(4):
        assert res.outputs[0][k].tobytes() == want.tobytes(), k


# (arch, overrides, what the refusal names) over tp = 4: the stock
# SMOKE's 2 wkv heads, an RWKV6 d_ff of 322 columns, a Mamba d_inner of
# 3 · 66 channels
REFUSED = ((RWKV, {}, "do not divide the 2 RWKV6 wkv heads"),
           (RWKV, {**RWKV4, "d_ff": 322},
            "do not divide the 322 RWKV6 channel-mix d_ff columns"),
           (JAMBA, {"d_model": 66, "head_dim": 16, "expand": 3},
            "do not divide the 198 Mamba d_inner channels"))


@pytest.mark.parametrize("name,over,match", REFUSED)
def test_unsplittable_mixers_are_refused_and_run_whole_stacked(name, over,
                                                               match):
    """``plan_split`` refuses a mixer that tp = 4 cannot split whole,
    naming it; the stacked model at that layout runs every layer whole
    and still serves."""
    cfg = tconfigs.get_smoke(name, **over)
    with pytest.raises(ValueError, match=match):
        tparams.plan_split(cfg, make_host_mesh(1, 4))
    model = TModel(cfg, (1, 4), device="cpu")
    assert model.split is None
    params = model.load_params(tparams.init_params(cfg, 0, "cpu"))
    assert model.shards is WHOLE
    res = tserve.serve_loop(model, params, tserve.prompts_for(cfg, 2, 4, 0),
                            2)
    assert res.tokens.shape == (2, 2)


@pytest.mark.parametrize("name,over,extra", [(RWKV, RWKV4, 1), (JAMBA, {}, 1)])
def test_dry_run_prices_the_mixers_all_reduces(name, over, extra):
    """The dry run prices the all-reduces of RWKV6's wo and Mamba's
    out_proj from their constraint sites; the processes make one more a
    RWKV6 layer (cm_wv) and a Mamba layer (x_proj), which the
    reference's program leaves to the compiler, and the embedding's: a
    decode step of the split smoke models at (1, 4)."""
    cfg = tconfigs.get_smoke(name, **over)
    mesh = make_host_mesh(1, 4)
    shape = tsteps.ShapeSpec("decode_b4_s16", "decode", 16, 4)
    coll = tsteps.lower_cell(cfg, shape, mesh).compile().collectives()
    mixers = sum(s.kind in ("rwkv", "mamba") for s in cfg.pattern()) \
        * cfg.n_repeats
    assert tparams.all_reduces(cfg, tparams.plan_split(cfg, mesh)) == \
        coll.op_counts["all-reduce"] + extra * mixers + 1


@pytest.mark.parametrize("name,over", [(RWKV, RWKV4), (JAMBA, {})])
def test_stacked_model_holds_the_mixer_shares(name, over):
    """On one device at (1, 4) the mixers' leaves are held as the four
    shares stacked after "layers" (``in_proj``'s share its x_in columns
    then the same z columns, ``cm_wr`` whole), and the caches hold each
    share's wkv heads of the state and d_inner channels of conv and h;
    a process's cache holds its own."""
    cfg = tconfigs.get_smoke(name, **over)
    mesh = make_host_mesh(1, 4)
    tree = tparams.init_params(cfg, 0, "cpu")
    model = TModel(cfg, (1, 4), device="cpu")
    held = model.load_params(tree)
    kinds = [s.kind for s in cfg.pattern()]
    for j in range(4):
        part = tparams.shard_params(tree, cfg, mesh, j)
        for kind, b, h, w in zip(kinds, part["blocks"], held["blocks"],
                                 tree["blocks"]):
            if kind == "rwkv":
                assert torch.equal(h["cm_wr"], w["cm_wr"])
                assert h["wr"].shape[1:] == (4, cfg.d_model, cfg.d_model // 4)
                assert torch.equal(h["cm_wv"][:, j], b["cm_wv"])
            if kind == "mamba":
                di, n = cfg.d_inner, cfg.d_inner // 4
                assert torch.equal(h["in_proj"][:, j], torch.cat(
                    [w["in_proj"][..., j * n:(j + 1) * n],
                     w["in_proj"][..., di + j * n:di + (j + 1) * n]], -1))
                assert torch.equal(h["in_proj"][:, j], b["in_proj"])
    cache = model.init_cache(2, 8)
    r = cfg.n_repeats
    for kind, c in zip(kinds, cache):
        if kind == "rwkv":
            assert c["state"].shape == (r, 4, 2, cfg.d_model // 64 // 4, 64,
                                        64)
            assert c["shift"].shape == (r, 2, 1, cfg.d_model)
        if kind == "mamba":
            assert c["conv"].shape == (r, 4, 2, cfg.d_conv - 1,
                                       cfg.d_inner // 4)
            assert c["h"].shape == (r, 4, 2, cfg.d_inner // 4, cfg.d_state)


def test_serve_cli_splits_rwkv_over_processes(capsys):
    """``serve --model-mesh 2 --backend gloo`` serves the stock RWKV6
    SMOKE (2 wkv heads, one a process) and prints and returns the
    stacked CLI's tokens."""
    args = ["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--gen", "3",
            "--model-mesh", "2"]
    want = tserve.serve(args)
    got = tserve.serve(args + ["--backend", "gloo"])
    np.testing.assert_array_equal(got, want)
    text = capsys.readouterr().out
    assert "1 x 2 ranks as 2 processes over gloo" in text
