"""The MoE layer and the served model with their (data, model) ranks held
by processes, on gloo pools on the CPU, against the stacked port and the
JAX package.

Process k of a 4-process pool is mesh rank (i, j) = divmod(k, tp) of a
(1, 4) or (2, 2) grid: it holds its rows of the batch and its e_pad/tp
experts, and its MoE layers exchange the capacity-padded buffers with
``all_to_all`` over its data shard's "model" processes.  Held against
the stacked ``moe_ffn`` (every group on one device) it must give the
same y, aux and kept flags bit for bit: the groups, the capacity, the
routing products and the experts' rows are the same, and the metrics
are taken from every group's gathered probabilities in the stacked
order.  Against the JAX package's ``moe_ffn`` on the same mesh (emulated
in this process by ``test_torch_moe_ffn._reference_on_mesh``) the same
tokens must drop, and y agrees at the cross-mesh fp32 tolerance.  The
collectives are counted per process and held to their formula, the
dispatch scan to its plan.  ``serve`` over the pool gives the stacked
model's tokens, and its prefill logits are the JAX package's forward's.
On one card the attention takes the batch a data shard at a time, so
the stacked run's products have the shapes the processes' have.
"""

import contextlib
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.core import scan_api as rsa
from repro.models.model import Model as RModel
from repro_torch import configs as tconfigs
from repro_torch.core import schedule as tsch
from repro_torch.dist import WorkerPool
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.sharding import rules as tsharding_rules
from helpers import run_with_devices
from test_torch_moe_ffn import _reference_on_mesh

ATOL, RTOL = 3e-4, 3e-3
NAME = "qwen2_moe_a2_7b"
LAYOUTS = [(1, 4), (2, 2)]
TIMEOUT = 120


def _mesh(ranks):
    return (("data", ranks[0]), ("model", ranks[1]))


@pytest.fixture(scope="module")
def pool4():
    """Four gloo processes on the CPU, one rank each; each keeps an
    executor a grid, so the one pool serves both layouts."""
    p = WorkerPool(4, backend="gloo", device="cpu", timeout=TIMEOUT)
    yield p
    p.close()


@pytest.fixture(params=LAYOUTS, ids=lambda r: f"{r[0]}x{r[1]}")
def pool(pool4, request):
    """The four processes as the layout's (data, model) grid."""
    pool4.ranks = request.param
    return pool4


# (B, S, config overrides, what the grouping is at (1, 4) and (2, 2)):
# a prefill the weight-stationary grouping replicates (B·S·k <= 4096),
# one split over the data processes and then the model ones, decode
# under weight-stationary and token-split dispatch, decode split over
# data without weight-stationary, and the small-batch fallback (B = 3
# does not split over 2 data ranks: every process holds every row)
CASES = [(2, 64, {}), (2, 1100, {}), (4, 1, {}),
         (4, 1, {"moe_weight_stationary": False}),
         (3, 8, {"moe_weight_stationary": False})]


@contextlib.contextmanager
def _one_thread():
    """The pool's processes pin themselves to one thread, and a CPU
    product's bits can follow the thread count: the stacked runs they
    are held to bit for bit run on one thread too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _pool_moe(pool, B, S, over, x, seed=0):
    return pool.call("moe_ffn", np.stack([x] * pool.p), arch=NAME,
                     smoke=True, ranks=pool.ranks, batch=B, seed=seed,
                     mesh=_mesh(pool.ranks), **over)


def _layer_collectives(cfg, B, S, ranks, itemsize):
    """Each process's all-to-alls, all-gathers and all-reduces of one MoE
    layer call: {kind: (calls, bytes)}.  Two all-to-alls of the
    (e_pad·cap, d) send buffer over tp > 1 model processes; all-gathers
    of x over "data" where the weight-stationary grouping replicates a
    batch the data processes split, of y over "model" under token split,
    and of the (n0, e_pad + k) fp32 router probabilities and kept flags
    over the processes whose groups differ; where the weight-stationary
    grouping runs over n_data > 1 data processes, the expert FFN's
    d-sliced (2, e_local, tp·cap, f) (g, u) partials all-reduced and its
    (e_local, tp·cap, d/n_data) outputs all-gathered over "data"."""
    D, tp = ranks
    e_pad, k, d = tparams.experts_padded(cfg), cfg.top_k, cfg.d_model
    gr = tmoe.moe_groups(cfg, B, S, make_host_mesh(*ranks))
    cap = tmoe.capacity(cfg, gr.n0, k)
    a2a = (2, 2 * e_pad * cap * d * itemsize) if tp > 1 else (0, 0)
    split = D > 1 and B % D == 0
    gathers = []
    if gr.ws and split:
        gathers.append(B // D * S * d * itemsize)
    if gr.token_split and tp > 1:
        gathers.append(gr.n0 * d * itemsize)
    if gr.n_groups > 1:
        gathers.append(gr.n0 * (e_pad + k) * 4)
    reduces = (0, 0)
    if gr.ws and D > 1:
        rows = (e_pad // tp) * tp * cap
        gathers.append(rows * d // D * itemsize)
        reduces = (1, 2 * rows * cfg.moe_d_ff * itemsize)
    return {"all_to_all": a2a, "all_gather": (len(gathers), sum(gathers)),
            "all_reduce": reduces}


def _dispatch_plan(cfg, B, S, ranks):
    """The dispatch scan's plan (``moe.dispatch_plan``) and its schedule
    over the whole grid (the processes of the other axis, where it spans
    one, run it alike); None for one group."""
    got = tmoe.dispatch_plan(cfg, B, S, make_host_mesh(*ranks))
    if got.plan is None:
        return None, None
    return got.plan, tsch.on_mesh(got.plan.schedule(), got.spec.axes,
                                  _mesh(ranks))


@pytest.mark.parametrize("B,S,over", CASES)
def test_moe_ffn_over_processes_is_the_stacked_layer(pool, B, S, over):
    """y, aux and the kept flags bit for bit the stacked layer's on every
    process's rows; each process's collectives their formula, its
    dispatch scan's rounds and ⊕ the plan's, the crossing messages and
    bytes ``expected_messages`` of its schedule over the grid."""
    cfg = tconfigs.get_smoke(NAME, **over)
    x = _x(cfg, B, S, seed=B * S)
    res = _pool_moe(pool, B, S, over, x)
    mesh = make_host_mesh(*pool.ranks)
    p = tparams.init_moe_layer(cfg, 0, "cpu")
    with _one_thread():
        y, aux, kept = tmoe._moe_ffn(cfg, p, torch.from_numpy(x), mesh,
                                     None, None)
    got_y, got_aux, got_kept = res.outputs
    for k in range(pool.nprocs):
        rows = tmoe.held_rows(B, mesh, k)
        assert np.array_equal(got_y[k], y[rows].numpy()), k
        assert np.array_equal(got_kept[k], kept[rows].numpy()), k
        assert got_aux[k].tobytes() == aux.numpy().tobytes(), k
    want = _layer_collectives(cfg, B, S, pool.ranks, 4)
    tr = res.transport
    for kind, (calls, nbytes) in want.items():
        assert (tr[kind], tr[kind + "_bytes"]) == (pool.nprocs * calls,
                                                   pool.nprocs * nbytes)
    assert tr["staged_copies"] == 0
    pl, sched = _dispatch_plan(cfg, B, S, pool.ranks)
    want_st = (0, 0) if pl is None else (pl.rounds, pl.op_applications)
    assert {(st["rounds"], st["op_applications"])
            for st in res.rank_stats} == {want_st}
    msgs = (0, 0) if pl is None else tsch.expected_messages(
        sched, torch.zeros(tparams.experts_padded(cfg), dtype=torch.int32))
    assert (tr["msgs"], tr["bytes"]) == msgs


def test_groupings_cover_the_cases():
    """The cases reach every grouping of the layer at (2, 2): the
    weight-stationary gather of a split batch, the split over data and
    model, token-split decode and the replicated fallback."""
    mesh = make_host_mesh(2, 2)
    got = []
    for B, S, over in CASES:
        gr = tmoe.moe_groups(tconfigs.get_smoke(NAME, **over), B, S, mesh)
        got.append((gr.ws, gr.token_split, gr.n_data, gr.n_groups))
    assert got == [(True, True, 1, 2), (False, True, 2, 4),
                   (True, True, 1, 2), (False, True, 2, 4),
                   (False, True, 1, 2)]


@functools.cache
def _reference_mesh(B, S, ranks):
    """The JAX package's moe_ffn on the emulated (data, model) mesh, its
    scan as "native" (see ``test_torch_moe_ffn.reference_2x4``), on the
    weights the pool draws."""
    cfg = rconfigs.get_smoke(NAME, scan=rsa.ScanSpec(kind="exclusive",
                                                     algorithm="native"))
    p = {k: v.numpy() for k, v in tparams.init_moe_layer(
        tconfigs.get_smoke(NAME), 0, "cpu").items()}
    x = _x(cfg, B, S, seed=B * S)
    return x, _reference_on_mesh(cfg, p, x, ranks)


@pytest.mark.parametrize("B,S", [(2, 1100), (4, 1)])
def test_moe_ffn_over_processes_drops_as_the_reference(pool, B, S):
    """The same (token, slot)s drop as in the reference's ``moe_ffn`` on
    the same mesh (the dropped fraction equal exactly), y and aux at the
    cross-mesh fp32 tolerance."""
    x, (want, want_aux) = _reference_mesh(B, S, pool.ranks)
    res = _pool_moe(pool, B, S, {}, x)
    mesh = make_host_mesh(*pool.ranks)
    if S > 1:  # the prefill drops at the default capacity
        assert want_aux[1] > 0.05
    for k in range(pool.nprocs):
        y, aux = res.outputs[0][k], res.outputs[1][k]
        assert aux[1] == want_aux[1]
        np.testing.assert_allclose(y, want[tmoe.held_rows(B, mesh, k)],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(aux, want_aux, atol=ATOL, rtol=RTOL)


def _model_slice(cfg, mesh, rank, path, leaf, spec):
    """The part of the whole ``leaf`` process ``rank`` holds, read off
    its sharding ``spec``: the dim it splits over "model", evenly, but
    the kv heads, whole heads by ``params.kv_heads_of``, and Mamba's
    ``in_proj``, whose x_in and z columns each split evenly; RWKV6's
    ``cm_wr`` whole."""
    on = [i for i, e in enumerate(spec.spec)
          if "model" in tsharding_rules.entry_axes(e)]
    kind = cfg.pattern()[path[1]].kind if len(path) == 3 else "top"
    if not on or path[-1] == "cm_wr":  # held whole
        return leaf
    tp, j = mesh.shape["model"], rank % mesh.shape["model"]
    dim = on[0]
    if path[-1] in ("wk", "wv") and kind == "attn":
        lo, hi = tparams.kv_heads_of(cfg, tparams.plan_split(cfg, mesh), j)
        hd = cfg.head_dim_
        return leaf.narrow(dim, lo * hd, (hi - lo) * hd)
    if path[-1] == "in_proj":
        half = leaf.shape[dim] // 2
        n = half // tp
        return torch.cat([leaf.narrow(dim, j * n, n),
                          leaf.narrow(dim, half + j * n, n)], dim=dim)
    n = leaf.shape[dim] // tp
    return leaf.narrow(dim, j * n, n)


def _data_slice(mesh, rank, leaf, spec):
    """Data rank i = rank // tp's slice of the dim ``spec`` splits over
    "data" (FSDP: the "embed" dim), evenly, of ``leaf`` (a model rank's
    part); the leaf itself where no dim is."""
    on = [i for i, e in enumerate(spec.spec)
          if "data" in tsharding_rules.entry_axes(e)]
    if not on:
        return leaf
    n_data, i = mesh.shape["data"], rank // mesh.shape["model"]
    n = leaf.shape[on[0]] // n_data
    return leaf.narrow(on[0], i * n, n)


@pytest.mark.parametrize("ranks", LAYOUTS)
@pytest.mark.parametrize("name", ["qwen2_moe_a2_7b", "granite_moe_3b_a800m"])
def test_shard_params_are_slices_of_the_stacked_tree(name, ranks):
    """Each process's leaves are exact slices of the stacked tree, drawn
    apart from the same seed or cut from it: its e_pad/tp routed experts
    and its share of every dense leaf the rule table splits over
    "model" (heads, kv heads whole, d_ff, shared experts, vocabulary),
    then at (2, 2) its data rank's half of every "embed" dim (FSDP: the
    router's rows and the experts' d too); the norms whole.  It holds
    1/(tp·n_data) of the expert bytes and less than the whole of the
    dense ones."""
    cfg = tconfigs.get_smoke(name)
    mesh = make_host_mesh(*ranks)
    whole = tparams.init_params(cfg, 3, "cpu")
    specs = tparams.param_shardings(cfg, mesh, tsharding_rules.rules_for(cfg))
    e_pad, tp = tparams.experts_padded(cfg), ranks[1]
    for rank in range(ranks[0] * ranks[1]):
        lo, hi = tmoe.expert_range(cfg, mesh, rank)
        assert (lo, hi) == (rank % tp * e_pad // tp,
                            (rank % tp + 1) * e_pad // tp)
        cut = tparams.shard_params(whole, cfg, mesh, rank)
        drawn = tparams.init_params(cfg, 3, "cpu", share=(mesh, rank))
        for tree in (cut, drawn):
            for pos, (a, b) in enumerate(zip(tree["blocks"],
                                             whole["blocks"])):
                for key in b:
                    spec = specs["blocks"][pos][key]
                    want = _data_slice(mesh, rank, _model_slice(
                        cfg, mesh, rank, ("blocks", pos, key), b[key],
                        spec), spec)
                    if tparams.is_expert_leaf(key):
                        assert torch.equal(want, _data_slice(
                            mesh, rank, b[key][:, lo:hi], spec)), key
                    assert torch.equal(a[key], want), key
                    if key in ("norm1", "norm2"):
                        assert a[key].shape == b[key].shape, key
                    if key == "router":
                        assert a[key].shape[1:] == (
                            cfg.d_model // ranks[0], e_pad), key
            for key in whole["top"]:
                spec = specs["top"][key]
                want = _data_slice(mesh, rank, _model_slice(
                    cfg, mesh, rank, (key,), whole["top"][key], spec), spec)
                assert torch.equal(tree["top"][key], want), key
        held, total = tparams.nbytes(cut), tparams.nbytes(whole)
        assert held["dense"] * tp * ranks[0] > total["dense"] > \
            held["dense"]
        assert held["experts"] * tp * ranks[0] == total["experts"] > 0


SERVED = ("qwen2_moe_a2_7b", "granite_moe_3b_a800m", "jamba_1_5_large_398b")
SB, SP, SG = 4, 8, 4  # requests, prompt tokens, generated tokens


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@functools.cache
def _reference_weights(name):
    """The JAX package's smoke weights, as numpy."""
    model = RModel(rconfigs.get_smoke(name), _mesh1())
    return jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))


def _stacked(name, ranks):
    """The stacked port at ``ranks`` on the reference's weights: its
    served tokens and its forward's logits at the prompts' last
    position (one thread, as the pool's processes run)."""
    cfg = tconfigs.get_smoke(name)
    prompts = tserve.prompts_for(cfg, SB, SP, 0)
    model = TModel(cfg, ranks, device="cpu")
    params = model.load_params(tparams.from_reference(
        _reference_weights(name), cfg, "cpu"))
    with _one_thread():
        res = tserve.serve_loop(model, params, prompts, SG)
        logits, _ = model.forward(params, torch.from_numpy(prompts))
    return res.tokens, logits[:, -1].numpy()


@functools.cache
def _reference_logits():
    """The JAX package's forward on each served model's smoke weights
    and the prompts, jitted on a (data, model) mesh of each layout over
    four fake CPU devices in a subprocess (``run_with_devices``), its
    scan "native" as in ``_reference_mesh``: the logits at the last
    position, by (name, ranks).  The mesh's groups decide which tokens
    drop, so the layout is the pool's."""
    out = os.path.join(tempfile.mkdtemp(prefix="moe-procs-"), "logits.npz")
    run_with_devices(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro import configs
        from repro.core import scan_api
        from repro.models.model import Model

        def mesh(d, m):
            return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                        ("data", "model"))

        got = {{}}
        for name in {SERVED!r}:
            cfg = configs.get_smoke(name, scan=scan_api.ScanSpec(
                kind="exclusive", algorithm="native"))
            params = Model(cfg, mesh(1, 1)).init_params(
                jax.random.PRNGKey(0))
            prompts = np.random.default_rng(0).integers(
                1, cfg.vocab, ({SB}, {SP})).astype(np.int32)
            for d, m in {LAYOUTS!r}:
                model = Model(cfg, mesh(d, m))
                with jax.set_mesh(model.mesh):
                    logits, _ = jax.jit(model.forward)(
                        params, jnp.asarray(prompts))
                got[f"{{name}}/{{d}}x{{m}}"] = np.asarray(logits)[:, -1]
        np.savez({out!r}, **got)
    """, n_devices=4, x64=False)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("name", SERVED)
def test_serve_over_processes(pool, name):
    """Qwen, granite MoE and Jamba (Mamba + attention + MoE) served over
    the pool on the reference's weights (``from_reference``, then each
    process's ``shard_params``): the stacked model's tokens at the same
    ranks, prefill logits the JAX package's forward's and the stacked
    port's, each process holding its share of the dense weights
    (``shard_params``) and e_pad/tp of the experts, at (2, 2) each
    expert's half of d (FSDP)."""
    want_tokens, want_logits = _stacked(name, pool.ranks)
    got = tserve.serve_procs(pool, arch=name, smoke=True, batch=SB,
                             prompt_len=SP, gen=SG, seed=0,
                             ranks=pool.ranks,
                             weights=_reference_weights(name))
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    np.testing.assert_allclose(
        got["prefill_logits"],
        _reference_logits()[f"{name}/{pool.ranks[0]}x{pool.ranks[1]}"],
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["prefill_logits"], want_logits,
                               atol=ATOL, rtol=RTOL)
    assert len(got["step_s"]) == SG - 1 and got["prefill_s"] > 0
    cfg = tconfigs.get_smoke(name)
    whole = tparams.init_params(cfg, 0, "cpu")
    total = tparams.nbytes(whole)
    held = got["result"].outputs[3]
    mesh = make_host_mesh(*pool.ranks)
    for k in range(pool.nprocs):
        share = tparams.nbytes(tparams.shard_params(whole, cfg, mesh, k))
        assert held[k, 0] == share["dense"] < total["dense"]
    assert (held[:, 1] * pool.ranks[1] * pool.ranks[0]
            == total["experts"]).all()
    tr = got["result"].transport
    n_moe = sum(s.use_moe for s in cfg.pattern()) * cfg.n_repeats
    # prefill and SG - 1 decode steps, two all-to-alls a MoE layer each
    assert tr["all_to_all"] == pool.nprocs * 2 * n_moe * SG
    assert tr["msgs"] > 0 and tr["staged_copies"] == 0


@pytest.mark.parametrize("ranks,blocks", [((1, 4), 1), ((2, 2), 2)])
def test_stacked_attention_takes_a_data_shard_at_a_time(monkeypatch, ranks,
                                                        blocks):
    """The stacked model attends the batch a data shard at a time
    (``Model._rows``), in prefill and decode, and each shard's attention
    is that shard's alone, bit for bit, into its own rows of the
    cache."""
    from repro_torch.models import attention as tatt
    from repro_torch.models import model as tmodel

    seen = []

    def spy(cfg, p, x, *a, **kw):
        seen.append(x.shape[0])
        return tatt.attention_block(cfg, p, x, *a, **kw)

    monkeypatch.setattr(tmodel, "attention_block", spy)
    cfg = tconfigs.get_smoke(NAME)
    model = TModel(cfg, ranks, device="cpu")
    params = model.init_params(0)
    tserve.serve_loop(model, params, tserve.prompts_for(cfg, SB, SP, 0), 2)
    assert seen and set(seen) == {SB // blocks}
    p = {k: v[0] for k, v in params["blocks"][0].items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((SB, SP, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(SP, dtype=torch.int32).expand(SB, SP)

    shards = model._shards("heads")  # the model's shares of the heads

    def attend(x, pos, cache):
        out, cache = tatt.attention_block(
            cfg, p, x, pos, window=0, cache=cache, cache_len=0,
            shards=shards)
        step, _ = tatt.attention_block(
            cfg, p, out[:, -1:], pos[:, -1:] + 1, window=0, cache=cache,
            cache_len=SP, shards=shards)
        return torch.cat([out, step], dim=1)

    def cache_of(n):
        c = model.init_cache(n, SP + 1)[0]
        return {"k": c["k"][0], "v": c["v"][0]}

    cache = cache_of(SB)
    with model._call(SB, None):
        whole = model._rows(attend, x, pos, cache=cache)
    for lo in (0, SB // 2):
        rows = slice(lo, lo + SB // 2)
        own = cache_of(SB // 2)
        assert torch.equal(whole[rows], attend(x[rows], pos[rows], own))
        lead = 1 if shards.stacked else 0
        for key in ("k", "v"):
            assert torch.equal(cache[key].narrow(lead, lo, SB // 2),
                               own[key])


def test_serve_cli_over_processes_gives_the_stacked_tokens(capsys):
    """``serve --backend gloo`` on two processes (1 × 2) prints and
    returns the stacked CLI's tokens."""
    args = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--gen", "3"]
    want = tserve.serve(args + ["--model-mesh", "2"])
    got = tserve.serve(args + ["--model-mesh", "2", "--backend", "gloo"])
    np.testing.assert_array_equal(got, want)
    text = capsys.readouterr().out
    for line in ("1 x 2 ranks as 2 processes over gloo",
                 "decode step latency: p50", "process 1 on cpu",
                 f"tokens in batch order: {want.tolist()}"):
        assert line in text


def test_fsdp_sp_forward_over_processes_is_refused(pool):
    """What stays refused of fsdp_sp over processes: serving with a cache
    (its sequence over "model", ROADMAP Queue 1 item 2.4) and the MoE
    configs (the reference's decision: "experts" and "embed" both over
    "model"), every process before a message; the pool stays up and
    runs the fsdp_sp forward without a cache (an RWKV6 SMOKE of 4 wkv
    heads, each process its positions of its rows)."""
    with pytest.raises(RuntimeError, match="NotImplementedError.*Queue 1 "
                                           "item 2.4"):
        pool.call("serve", None, arch="rwkv6_1_6b", smoke=True, batch=2,
                  prompt_len=8, gen=1, ranks=pool.ranks,
                  sharding_strategy="fsdp_sp", d_model=256, n_heads=4,
                  n_kv_heads=4, mesh=_mesh(pool.ranks))
    with pytest.raises(RuntimeError, match="ValueError: .*'model'"):
        pool.call("serve", None, arch=NAME, smoke=True, batch=2,
                  prompt_len=8, gen=1, ranks=pool.ranks, forward=True,
                  sharding_strategy="fsdp_sp", mesh=_mesh(pool.ranks))
    res = pool.call("serve", None, arch="rwkv6_1_6b", smoke=True, batch=2,
                    prompt_len=8, gen=1, ranks=pool.ranks, forward=True,
                    sharding_strategy="fsdp_sp", mesh=_mesh(pool.ranks),
                    d_model=256, n_heads=4, n_kv_heads=4)
    assert res.outputs[0].shape[2] == 8 // pool.ranks[1]


def test_unsupported_layouts_are_refused():
    """tp not dividing the padded experts, and blocks of more than one
    rank a process: a ``ValueError`` on every process before a message,
    from the layer and from the model, on three processes of two ranks
    as a (2, 3) and a (3, 2) grid."""
    cases = (((2, 3), "tp = 3 model processes do not divide the 16 padded"),
             ((3, 2), "holds one rank a process, not 2"))
    with WorkerPool(3, backend="gloo", device="cpu", timeout=TIMEOUT,
                    p_intra=2) as p:
        x = np.zeros((p.p, 2, 4, tconfigs.get_smoke(NAME).d_model),
                     np.float32)
        for ranks, match in cases:
            for entry, kw in (("moe_ffn", {"x": x}),
                              ("serve", {"x": None, "prompt_len": 4,
                                         "gen": 1})):
                args = dict(kw)
                with pytest.raises(RuntimeError,
                                   match=f"ValueError: .*{match}"):
                    p.call(entry, args.pop("x"), arch=NAME, smoke=True,
                           ranks=ranks, batch=2, mesh=_mesh(ranks), **args)
        # the pool stays up
        top_e = np.zeros((p.p, 4, 2), np.int32)
        assert p.call("dispatch_slots", top_e, arch=NAME,
                      smoke=True).outputs[0].shape == (p.p, 4, 2)
