"""Attention models served with their dense layers split over the "model"
processes, on a 4-process gloo pool on the CPU, against the JAX package
and the stacked port.

Process k of the pool is mesh rank (i, j) = divmod(k, tp) of a (1, 4)
or (2, 2) grid.  It holds model rank j's share of every leaf the "tp"
rule table splits over "model" (``params.shard_params``): its q heads
and the kv heads they read (Llama's and Gemma's 2 kv heads at tp = 4:
each held by two processes), wo's matching rows, its columns of the
FFN's and the shared experts' gate and up and rows of their down, its
rows of the embedding and columns of the head.  Each row-split product
is summed by ``SPMDExecutor.all_reduce`` over "model" (the partials
gathered and added in group order), the embedding is looked up by
vocabulary shard and all-reduced, the logits all-gathered.

Held against the stacked port at the same ranks, which computes the
same shards on one device and sums them in the same order, tokens and
logits are equal bit for bit (both on one thread).  Against the JAX
package's ``Model`` on one CPU device, on the same weights
(``params.from_reference``), the prefill logits agree within the
cross-framework fp32 tolerance ATOL, RTOL and the greedy tokens are
equal.  Qwen's MoE layers group their tokens by the mesh, so another
mesh drops other tokens: its split run is held to the JAX package's
forward on the pool's own mesh of four fake devices by
``test_torch_moe_procs.test_serve_over_processes``, and here to the
stacked port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.models.model import Model as RModel
from repro_torch import configs as tconfigs
from repro_torch.core import schedule as tsch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.sharding import rules as trules
from test_torch_moe_procs import (LAYOUTS, _mesh, _one_thread, pool,
                                  pool4)  # noqa: F401

ATOL, RTOL = 3e-4, 3e-3  # fp32 smoke logits, JAX against the port
DENSE = ("llama3_8b", "gemma2_9b")
SERVED = DENSE + ("qwen2_moe_a2_7b",)
SB, SP, SG = 4, 8, 4  # requests, prompt tokens, generated tokens


@functools.cache
def _reference(name):
    """The JAX package's ``Model`` on one CPU device: its smoke weights
    from PRNGKey(0) as numpy, the served tokens of its prefill and
    greedy decode (``src/repro/launch/serve.py``'s loop) and the
    prefill's last logits, on ``serve.prompts_for``'s prompts."""
    cfg = rconfigs.get_smoke(name)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    model = RModel(cfg, mesh)
    params = model.init_params(jax.random.PRNGKey(0))
    prompts = tserve.prompts_for(tconfigs.get_smoke(name), SB, SP, 0)
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


def _stacked(name, ranks):
    """The stacked port at ``ranks`` on the reference's weights (one
    thread, as the pool's processes run): its served tokens and prefill
    logits, and its forward's logits."""
    cfg = tconfigs.get_smoke(name)
    model = TModel(cfg, ranks, device="cpu")
    params = model.load_params(tparams.from_reference(
        _reference(name)[0], cfg, "cpu"))
    prompts = tserve.prompts_for(cfg, SB, SP, 0)
    with _one_thread():
        res = tserve.serve_loop(model, params, prompts, SG)
        logits, _ = model.forward(params, torch.from_numpy(prompts))
    return res.tokens, res.prefill_logits.numpy(), logits.numpy()


def _share_bytes(cfg, ranks) -> int:
    """A process's dense bytes, counted from the configuration alone:
    a leaf split over "model" holds 1/tp of its elements (attention's,
    the FFN's, the vocabulary's, RWKV6's and Mamba's mixers'), the kv
    heads max(1, n_kv/tp) of n_kv, every other leaf whole, and so does
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
    embedding's, and each layer's row-split products: attention's wo,
    RWKV6's wo and cm_wv, Mamba's x_proj and out_proj, and its FFN's
    (or shared experts') w_down."""
    n = 1
    for s in cfg.pattern():
        ffn = s.kind != "rwkv" and (not s.use_moe
                                    or bool(cfg.n_shared_experts))
        n += cfg.n_repeats * ({"attn": 1, "rwkv": 2, "mamba": 2}[s.kind]
                              + int(ffn))
    return calls * n


@pytest.mark.parametrize("name", SERVED)
def test_tp_serve_matches_reference_and_stacked(pool, name):
    """Served over the pool with the dense layers split, on the JAX
    package's weights: the stacked port's tokens and prefill logits bit
    for bit, and for the dense models the JAX package's prefill logits
    within ATOL, RTOL and its greedy tokens; each process
    holds its share of the dense bytes and makes one all-reduce for the
    embedding and two a layer in each of the SG calls, and one
    all-gather of the logits a call."""
    weights, ref_tokens, ref_logits = _reference(name)
    want_tokens, want_logits, _ = _stacked(name, pool.ranks)
    got = tserve.serve_procs(pool, arch=name, smoke=True, batch=SB,
                             prompt_len=SP, gen=SG, seed=0,
                             ranks=pool.ranks, weights=weights)
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    assert got["prefill_logits"].tobytes() == want_logits.tobytes()
    if name in DENSE:
        np.testing.assert_array_equal(got["tokens"], ref_tokens)
        np.testing.assert_allclose(got["prefill_logits"], ref_logits,
                                   atol=ATOL, rtol=RTOL)
    cfg = tconfigs.get_smoke(name)
    held = got["result"].outputs[3]
    assert (held[:, 0] == _share_bytes(cfg, pool.ranks)).all()
    tr = got["result"].transport
    # a weight-stationary call over two data processes all-reduces each
    # MoE layer's d-sliced expert partials over "data" besides
    mesh = make_host_mesh(*pool.ranks)
    ws = sum(n * (pool.ranks[0] > 1 and cfg.n_experts > 0 and
                  tmoe.moe_groups(cfg, SB, S, mesh).ws)
             for S, n in ((SP, 1), (1, SG - 1)))
    n_moe = sum(s.use_moe for s in cfg.pattern()) * cfg.n_repeats
    assert tr["all_reduce"] == pool.nprocs * (_all_reduces(cfg, SG)
                                              + ws * n_moe)
    if name in DENSE:  # the logits' (the MoE layers': test_torch_moe_procs)
        assert tr["all_gather"] == pool.nprocs * SG
    assert tr["staged_copies"] == 0


@pytest.mark.parametrize("name", DENSE)
def test_tp_forward_over_processes_is_the_stacked_forward(pool, name):
    """``Model.forward`` over the pool gathers every process's
    vocabulary columns: each process's (B_k, S, vocab_padded) logits are
    the stacked forward's rows bit for bit, and the JAX package's last
    position within ATOL, RTOL."""
    weights, _, ref_logits = _reference(name)
    _, _, want = _stacked(name, pool.ranks)
    res = pool.call("serve", None, arch=name, smoke=True, batch=SB,
                    prompt_len=SP, gen=1, ranks=pool.ranks, forward=True,
                    weights=weights, mesh=_mesh(pool.ranks))
    mesh = make_host_mesh(*pool.ranks)
    from repro_torch.models.moe import held_rows
    for k in range(pool.nprocs):
        logits = res.outputs[0][k]
        assert logits.shape == (SB // pool.ranks[0], SP,
                                tparams.vocab_padded(tconfigs.get_smoke(
                                    name)))
        assert logits.tobytes() == want[held_rows(SB, mesh, k)].tobytes()
        np.testing.assert_allclose(logits[:, -1], ref_logits[
            held_rows(SB, mesh, k)], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ranks", LAYOUTS)
@pytest.mark.parametrize("name", ("llama3_8b", "gemma2_9b",
                                  "qwen2_moe_a2_7b", "jamba_1_5_large_398b",
                                  "rwkv6_1_6b"))
def test_shard_params_are_the_rule_tables_model_slices(name, ranks):
    """Each process's leaves, cut from the whole tree or drawn apart
    from the same seed, are the slices the rule table's shardings
    (``param_shardings`` under "tp") put on its model rank: the dim
    they split over "model", evenly, but the kv heads, which a process
    holds whole (the heads its q heads read; at n_kv < tp one head that
    tp/n_kv processes share), and Mamba's ``in_proj``, whose x_in and z
    columns each split evenly; RWKV6's ``cm_wr`` whole over "model";
    then its data rank's slice of the dim they split over "data" (FSDP:
    the "embed" dim, at (2, 2)), evenly; and ``nbytes`` is the share
    counted from the configuration.  RWKV6's SMOKE takes 4 wkv heads,
    which split over 4 processes (its stock 2 do not)."""
    over = {"d_model": 256, "n_heads": 4, "n_kv_heads": 4} \
        if name == "rwkv6_1_6b" else {}
    cfg = tconfigs.get_smoke(name, **over)
    mesh = make_host_mesh(*ranks)
    specs = tparams.param_shardings(cfg, mesh, trules.rules_for(cfg))
    axes = tparams.logical_axes(cfg)
    whole = tparams.init_params(cfg, 5, "cpu")
    tp, hd = ranks[1], cfg.head_dim_
    for rank in range(ranks[0] * tp):
        j = rank % tp
        cut = tparams.shard_params(whole, cfg, mesh, rank)
        drawn = tparams.init_params(cfg, 5, "cpu", share=(mesh, rank))
        leaves = [(("top", k), whole["top"][k], specs["top"][k],
                   axes["top"][k]) for k in whole["top"]]
        leaves += [(("blocks", i, k), b[k], specs["blocks"][i][k],
                    axes["blocks"][i][k])
                   for i, b in enumerate(whole["blocks"]) for k in b]
        for path, leaf, spec, ax in leaves:
            on = [i for i, e in enumerate(spec.spec)
                  if "model" in trules.entry_axes(e)]
            want = leaf
            if on and path[-1] != "cm_wr":
                dim = on[0] if ax[on[0]] != "kv_heads" else ax.index(
                    "kv_heads")
                if ax[dim] == "kv_heads":
                    n = max(1, cfg.n_kv_heads // tp)
                    lo = j * n // max(1, tp // cfg.n_kv_heads)
                    want = leaf.narrow(dim, lo * hd, n * hd)
                elif path[-1] == "in_proj":  # [x_in | z]: each alike
                    half = leaf.shape[dim] // 2
                    n = half // tp
                    want = torch.cat([leaf.narrow(dim, j * n, n),
                                      leaf.narrow(dim, half + j * n, n)],
                                     dim=dim)
                else:
                    n = leaf.shape[dim] // tp
                    want = leaf.narrow(dim, j * n, n)
            data = [i for i, e in enumerate(spec.spec)
                    if "data" in trules.entry_axes(e)]
            if data:
                assert [ax[i] for i in data] == ["embed"], path
                n = want.shape[data[0]] // ranks[0]
                want = want.narrow(data[0], rank // tp * n, n)
            for tree in (cut, drawn):
                got = tree["top"][path[1]] if path[0] == "top" \
                    else tree["blocks"][path[1]][path[2]]
                assert torch.equal(got, want), (rank, path)
        assert tparams.nbytes(cut)["dense"] == _share_bytes(cfg, ranks)


def test_all_reduce_is_bit_identical_across_the_group(pool4):
    """``SPMDExecutor.all_reduce`` over "model", "data" and every
    process of the (1, 4) and (2, 2) grids, in fp32 and bf16: every
    process of a group holds the same bits, those of its group's inputs
    summed in group order in fp32 and cast once (``sum_in_order``), and
    each call is counted with the bytes it sends."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 3, 37)).astype(np.float32) * \
        10.0 ** rng.integers(-3, 4, (4, 3, 37))
    for ranks in LAYOUTS:
        D, tp = ranks
        for axis in ("model", "data", None):
            if axis == "model":
                groups = [[i * tp + j for j in range(tp)] for i in range(D)]
            elif axis == "data":
                groups = [[i * tp + j for i in range(D)] for j in range(tp)]
            else:
                groups = [list(range(4))]
            for dtype in ("float32", "bfloat16"):
                res = pool4.call("all_reduce", x, axis=axis, dtype=dtype,
                                 mesh=_mesh(ranks))
                got = res.outputs
                tdt = getattr(torch, dtype)
                for g in groups:
                    want = tsch.sum_in_order(torch.stack(
                        [torch.from_numpy(x[k]).to(tdt) for k in g]))
                    for k in g:
                        assert got[k].tobytes() == \
                            want.float().numpy().tobytes(), (ranks, axis, k)
                n = len(groups[0])
                tr = res.transport
                calls = 4 if n > 1 else 0
                assert tr["all_reduce"] == calls
                assert tr["all_reduce_bytes"] == calls * x[0].size * \
                    tdt.itemsize


def test_refused_layouts_raise_before_any_message(pool4):
    """A split the "tp" rule table asks for that the processes cannot
    make whole raises a ``ValueError`` in every process before a
    message, and the pool stays up: tp = 4 not dividing 6 heads, no
    duplication giving each process whole kv heads (12 heads, 6 kv
    heads), d_ff not dividing, the stock RWKV6 SMOKE's 2 wkv heads, an
    RWKV6 d_ff of 322, a Mamba d_inner of 198; the stacked model at such
    a layout runs its layers whole."""
    rwkv4 = {"d_model": 256, "n_heads": 4, "n_kv_heads": 4}
    cases = (("llama3_8b", {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16},
              "do not divide the 6 attention heads"),
             ("llama3_8b", {"n_heads": 12, "n_kv_heads": 6, "head_dim": 16},
              "no duplication of the 6 kv heads .*cache_seq_tp"),
             ("llama3_8b", {"d_ff": 190},
              "do not divide the 190 d_ff columns"),
             ("rwkv6_1_6b", {}, "do not divide the 2 RWKV6 wkv heads"),
             ("rwkv6_1_6b", {**rwkv4, "d_ff": 322},
              "do not divide the 322 RWKV6 channel-mix d_ff columns"),
             ("jamba_1_5_large_398b",
              {"d_model": 66, "head_dim": 16, "expand": 3},
              "do not divide the 198 Mamba d_inner channels"))
    for arch, over, match in cases:
        cfg = tconfigs.get_smoke(arch, **over)
        with pytest.raises(ValueError, match=match):
            tparams.plan_split(cfg, make_host_mesh(1, 4))
        assert TModel(cfg, (1, 4), device="cpu").split is None
        with pytest.raises(RuntimeError, match=f"ValueError: .*{match}"):
            pool4.call("serve", None, arch=arch, smoke=True,
                       batch=2, prompt_len=4, gen=1, ranks=(1, 4),
                       mesh=_mesh((1, 4)), **over)
    res = pool4.call("serve", None, arch="llama3_8b", smoke=True, batch=2,
                     prompt_len=4, gen=2, ranks=(1, 4), mesh=_mesh((1, 4)))
    assert res.outputs[0].shape == (4, 2, 2)


def test_dry_run_prices_the_layers_all_reduces():
    """The dry run prices the all-reduces of the row-split products: a
    decode step of smoke Llama at (1, 4) all-reduces wo's and w_down's
    outputs, two a layer, each (B, 1, d) fp32 at 2·(3/4) of its bytes on
    the wire; the processes make one more, the embedding's, which the
    reference's rules leave to the compiler."""
    cfg = tconfigs.get_smoke("llama3_8b")
    shape = tsteps.ShapeSpec("decode_b4_s16", "decode", 16, 4)
    coll = tsteps.lower_cell(cfg, shape, make_host_mesh(1, 4)).compile() \
        .collectives()
    layers = len(cfg.pattern()) * cfg.n_repeats
    assert coll.op_counts["all-reduce"] == 2 * layers
    assert coll.op_bytes["all-reduce"] == pytest.approx(
        2 * layers * 2 * (4 * cfg.d_model * 4) * 3 / 4)
    assert _all_reduces(cfg, 1) == coll.op_counts["all-reduce"] + 1


def test_stacked_model_holds_the_shares_cut_once():
    """On one device at (1, 4), a tree loaded for serving is held as the
    four shares stacked after "layers", share j the part process j
    holds (``shard_params``), and the attention caches hold each
    share's kv heads the same way; loaded trainable, or on the meta
    device, the tree is held whole.  A tree of other shapes passed to
    the split model's calls raises, and so does loading a cut tree."""
    from repro_torch.models.shards import WHOLE, StackedShards

    cfg = tconfigs.get_smoke("llama3_8b")
    mesh = make_host_mesh(1, 4)
    tree = tparams.init_params(cfg, 0, "cpu")
    model = TModel(cfg, (1, 4), device="cpu")
    held = model.load_params(tree)
    assert isinstance(model.shards, StackedShards)
    for j in range(4):
        part = tparams.shard_params(tree, cfg, mesh, j)
        for k, v in part["top"].items():
            want = held["top"][k][j] if v.shape != tree["top"][k].shape \
                else held["top"][k]
            assert torch.equal(want, v), k
        for b, h, w in zip(part["blocks"], held["blocks"], tree["blocks"]):
            for k, v in b.items():
                if v.shape == w[k].shape:  # held whole
                    assert torch.equal(h[k], v), k
                    continue
                assert torch.equal(h[k][:, j], v), k
                # a repeat's share, as a layer reads it, is contiguous
                assert all(h[k][r, j].is_contiguous()
                           for r in range(cfg.n_repeats)), k
    n_kv = max(1, cfg.n_kv_heads // 4)
    assert model.init_cache(2, 8)[0]["k"].shape == (
        cfg.n_repeats, 4, 2, 8, n_kv, cfg.head_dim_)
    for dev, trainable, params in (("cpu", True, tree),
                                   ("meta", False,
                                    tparams.abstract_params(cfg))):
        other = TModel(cfg, (1, 4), device=dev)
        got = other.load_params(params, trainable=trainable)
        assert other.shards is WHOLE
        assert all(a.shape == b.shape for a, b in zip(
            (got["top"]["tok_embed"], got["blocks"][0]["wq"]),
            (tree["top"]["tok_embed"], tree["blocks"][0]["wq"])))
    tokens = torch.from_numpy(tserve.prompts_for(cfg, 2, 4, 0))
    with pytest.raises(ValueError, match="pass the tree load_params"):
        model.forward(tree, tokens)
    with pytest.raises(ValueError, match="is not the whole leaf"):
        TModel(cfg, (1, 4), device="cpu").load_params(held)
