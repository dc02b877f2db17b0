"""Models served over processes with their weights split over "data" as
well as "model" (FSDP), on a 4-process gloo pool on the CPU as the
(2, 2) grid, against the stacked port and the JAX package.

Process k is mesh rank (i, j) = divmod(k, 2).  Besides model rank j's
share (``params.tp_cuts``) it holds data rank i's half of every leaf's
"embed" dim that the "tp" rule table puts on the data axes
(``params.data_cuts``), and each layer gathers its halves over "data" in
one all-gather where it is used (``shards.gather_data``); the embedding
is gathered at the lookup, the head at the logits.  In a
weight-stationary MoE call the experts stay sliced: each process
multiplies its half of d and the (g, u) partials are all-reduced over
"data", the outputs all-gathered (``moe.moe_ffn``).

A gather is exact, so against the stacked port at (2, 2), which holds
every leaf whole and computes the same d-sliced expert partials, tokens
and prefill logits are equal bit for bit (both on one thread).  Against
the JAX package, on the same weights (``params.from_reference``): the
dense models' greedy tokens and prefill logits on one CPU device (within
the cross-framework fp32 tolerance ATOL, RTOL), the MoE models' prefill
logits from its forward jitted on a (2, 2) mesh of four fake CPU devices
in a subprocess, since the mesh's groups decide which tokens drop; that
subprocess starts with the module's pool and runs beside the tests.
"""

import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as troofline
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.models.shards import StackedSlices
from repro_torch.sharding import rules as trules
from test_torch_mixer_procs import RWKV, RWKV4
from test_torch_mixer_procs import _reference as _rwkv_reference
from test_torch_moe_procs import (_mesh, _one_thread, _reference_weights,
                                  pool4)  # noqa: F401
from test_torch_tp_procs import _reference as _dense_reference

ATOL, RTOL = 3e-4, 3e-3  # fp32 smoke logits, JAX against the port
RANKS = (2, 2)
SB, SP, SG = 4, 8, 4  # requests, prompt tokens, generated tokens
QWEN, LLAMA, JAMBA = "qwen2_moe_a2_7b", "llama3_8b", "jamba_1_5_large_398b"
MOE = (QWEN, JAMBA)
# (name, config overrides): RWKV6 with 4 wkv heads, which split over tp
# (the MoE models last: their reference runs beside the tests before)
SERVED = ((LLAMA, {}), (RWKV, RWKV4), (QWEN, {}), (JAMBA, {}))


@functools.cache
def _moe_reference():
    """Start the JAX package's forward of each MoE model on its smoke
    weights and the prompts, jitted on a (2, 2) mesh of four fake CPU
    devices, its scan "native" (as ``test_torch_moe_procs``'s
    ``_reference_logits``, at this grid alone), in a subprocess; returns
    (the process, the file its last-position logits land in)."""
    from repro.launch.mesh import fake_device_env

    out = os.path.join(tempfile.mkdtemp(prefix="fsdp-procs-"), "logits.npz")
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro import configs
        from repro.core import scan_api
        from repro.models.model import Model

        def mesh(d, m):
            return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                        ("data", "model"))

        got = {{}}
        for name in {MOE!r}:
            cfg = configs.get_smoke(name, scan=scan_api.ScanSpec(
                kind="exclusive", algorithm="native"))
            params = Model(cfg, mesh(1, 1)).init_params(
                jax.random.PRNGKey(0))
            prompts = np.random.default_rng(0).integers(
                1, cfg.vocab, ({SB}, {SP})).astype(np.int32)
            model = Model(cfg, mesh(*{RANKS!r}))
            with jax.set_mesh(model.mesh):
                logits, _ = jax.jit(model.forward)(
                    params, jnp.asarray(prompts))
            got[name] = np.asarray(logits)[:, -1]
        np.savez({out!r}, **got)
    """)
    env = fake_device_env(4)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out


@functools.cache
def _moe_reference_logits(name):
    proc, out = _moe_reference()
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr
    with np.load(out) as f:
        return f[name]


@pytest.fixture(scope="module")
def pool(pool4):
    """The pool as the (2, 2) grid; the MoE reference starts beside it."""
    _moe_reference()
    pool4.ranks = RANKS
    return pool4


def _weights(name):
    """The JAX package's smoke weights of ``name`` as numpy (RWKV6's with
    4 wkv heads)."""
    if name == RWKV:
        return _rwkv_reference()[0]
    if name in MOE:
        return _reference_weights(name)
    return _dense_reference(name)[0]


def _stacked(name, over, weights):
    """The stacked port at (2, 2) on ``weights``, on one thread as the
    pool's processes run: its served tokens and prefill logits."""
    cfg = tconfigs.get_smoke(name, **over)
    model = TModel(cfg, RANKS, device="cpu")
    params = model.load_params(tparams.from_reference(weights, cfg, "cpu"))
    with _one_thread():
        res = tserve.serve_loop(model, params,
                                tserve.prompts_for(cfg, SB, SP, 0), SG)
    return res.tokens, res.prefill_logits.numpy()


def _call_gathers(cfg, mesh, k):
    """Process k's weight all-gathers over "data" in a prefill and SG - 1
    decode steps, each call's MoE grouping as ``moe.moe_groups`` takes
    it: {"calls", "bytes"}."""
    got = {"calls": 0, "bytes": 0}
    for S, n in ((SP, 1), (1, SG - 1)):
        ws = any(s.use_moe for s in cfg.pattern()) and \
            tmoe.moe_groups(cfg, SB, S, mesh).ws
        one = tparams.fsdp_gathers(cfg, mesh, k, ws=ws)
        got = {key: got[key] + n * one[key] for key in got}
    return got


def test_decode_ws_over_processes_runs_serve_and_moe_ffn(pool):
    """The decode_ws strategy (the activations' d over "data") runs over
    the processes (``tests/test_torch_decode_ws_procs.py`` holds it in
    full): the ``serve`` entry serves every row on every process, the
    batch replicated over "data", the stacked decode_ws twin's tokens;
    the ``moe_ffn`` entry's y is each process's d-slice of the stacked
    layer's under the same slices (``shards.StackedSlices``), aux and
    the kept flags the stacked layer's, bit for bit.  The pool stays
    up."""
    dws = {"sharding_strategy": "decode_ws"}
    cfg = tconfigs.get_smoke(QWEN, **dws)
    res = pool.call("serve", None, arch=QWEN, smoke=True, batch=2,
                    prompt_len=4, gen=2, ranks=RANKS, mesh=_mesh(RANKS),
                    **dws)
    model = TModel(cfg, RANKS, device="cpu")
    params = model.init_params(0)
    with _one_thread():
        want = tserve.serve_loop(model, params,
                                 tserve.prompts_for(cfg, 2, 4, 0), 2)
    for k in range(4):
        np.testing.assert_array_equal(res.outputs[0][k], want.tokens)
    x = np.random.default_rng(9).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    res = pool.call("moe_ffn", np.stack([x] * 4), arch=QWEN, smoke=True,
                    batch=4, ranks=RANKS, mesh=_mesh(RANKS), **dws)
    with _one_thread():
        y, aux, kept = tmoe._moe_ffn(
            cfg, tparams.init_moe_layer(cfg, 0, "cpu"), torch.from_numpy(x),
            make_host_mesh(*RANKS), None, None, StackedSlices(RANKS[0]))
    d_l = cfg.d_model // RANKS[0]
    for k in range(4):
        i = k // RANKS[1]
        assert res.outputs[0][k].tobytes() == \
            y[..., i * d_l:(i + 1) * d_l].numpy().tobytes()
        assert res.outputs[1][k].tobytes() == aux.numpy().tobytes()
        assert res.outputs[2][k].tobytes() == kept.numpy().tobytes()
    res = pool.call("serve", None, arch=QWEN, smoke=True, batch=2,
                    prompt_len=4, gen=2, ranks=RANKS, mesh=_mesh(RANKS))
    assert res.outputs[0].shape == (4, 1, 2)


@pytest.mark.parametrize("B,S", [(4, 1), (2, 64)])
def test_weight_stationary_moe_ffn_over_processes_is_the_stacked_layer(
        pool, B, S):
    """Qwen's MoE layer in a weight-stationary call over the (2, 2)
    pool, each process holding its experts' half of d: y, aux and the
    kept flags the stacked layer's (the same d-sliced partials summed in
    data order) bit for bit; one all-reduce over "data" of the (2,
    e_local, tp·cap, f) partials and one all-gather of the (e_local,
    tp·cap, d/2) outputs."""
    cfg = tconfigs.get_smoke(QWEN)
    mesh = make_host_mesh(*RANKS)
    gr = tmoe.moe_groups(cfg, B, S, mesh)
    assert gr.ws
    x = np.random.default_rng(B + S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    res = pool.call("moe_ffn", np.stack([x] * 4), arch=QWEN, smoke=True,
                    ranks=RANKS, batch=B, seed=0, mesh=_mesh(RANKS))
    with _one_thread():
        y, aux, kept = tmoe._moe_ffn(cfg, tparams.init_moe_layer(
            cfg, 0, "cpu"), torch.from_numpy(x), mesh, None, None)
    for k in range(4):
        rows = tmoe.held_rows(B, mesh, k)
        assert res.outputs[0][k].tobytes() == y[rows].numpy().tobytes()
        assert res.outputs[2][k].tobytes() == kept[rows].numpy().tobytes()
        assert res.outputs[1][k].tobytes() == aux.numpy().tobytes()
    e_local = tparams.experts_padded(cfg) // RANKS[1]
    rows = e_local * RANKS[1] * tmoe.capacity(cfg, gr.n0, cfg.top_k)
    for t in res.traffic:
        assert (t["all_reduce"], t["all_reduce_bytes"]) == (
            1, 2 * rows * cfg.moe_d_ff * 4)
        assert t["fsdp_gather"] == 0


def test_weight_stationary_partials_sum_in_data_order():
    """The stacked weight-stationary expert FFN is each d-slice's (g, u)
    partials summed in data order in fp32, cast once, then each slice of
    down: bit for bit that, and within fp32 rounding of the whole
    product."""
    rng = np.random.default_rng(3)
    t, gate, up = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((4, 6, 16), (4, 16, 8), (4, 16, 8)))
    down = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(
        np.float32))
    got = tmoe._ws_experts(t, gate, up, down, 2)
    parts = [torch.stack([t[..., c] @ gate[:, c], t[..., c] @ up[:, c]])
             for c in (slice(0, 8), slice(8, 16))]
    gu = (parts[0].float() + parts[1].float()).to(t.dtype)
    h = torch.nn.functional.silu(gu[0]) * gu[1]
    want = torch.cat([h @ down[..., :8], h @ down[..., 8:]], dim=-1)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, tmoe._swiglu_experts(t, gate, up, down),
                               atol=1e-4, rtol=1e-4)


# (name, shape) cells of the dry run at (2, 2): a weight-stationary MoE
# decode step, a MoE prefill past the weight-stationary limit (4·1024·2
# slots > 4096), a dense prefill
CELLS = ((QWEN, tsteps.ShapeSpec("decode_b4_s16", "decode", 16, 4)),
         (QWEN, tsteps.ShapeSpec("prefill_b4_s1024", "prefill", 1024, 4)),
         (LLAMA, tsteps.ShapeSpec("prefill_b4_s16", "prefill", 16, 4)))


@pytest.mark.parametrize("name,shape", CELLS,
                         ids=[f"{n}-{s.name}" for n, s in CELLS])
def test_fsdp_gathers_are_the_dry_runs_priced_all_gathers(name, shape):
    """Each process's weight all-gathers of one call
    (``params.fsdp_gathers``) land the bytes the dry run prices as the
    FSDP all-gathers of the cell (``collectives_of``: every leaf sharded
    over "data", the experts left out in a weight-stationary call), g −
    1 = 1 times the slices it sends: the priced all-gather bytes less
    those of the token-split gathers over "model".  The calls differ by
    the bucketing alone: the dry run prices one gather a stacked leaf,
    the processes make one a layer (a repeat's position) and one for
    each top leaf."""
    cfg = tconfigs.get_smoke(name)
    mesh = make_host_mesh(*RANKS)
    comp = tsteps.lower_cell(cfg, shape, mesh).compile()
    coll = comp.collectives()
    ws = any(c[0].startswith("moe.ws") for c in comp.constraints)
    assert ws == (name == QWEN and shape.kind == "decode")
    split = [troofline.wire_bytes("all-gather", np.prod(c[1]) * c[3],
                                  RANKS[1])
             for c in comp.constraints if c[0] == "moe.token_split"]
    priced = coll.op_bytes["all-gather"] - sum(split)
    cuts = tparams.data_cuts(cfg, mesh, 0)
    leaves = [p for p in cuts if not (ws and tparams.is_expert_leaf(p[-1]))]
    assert coll.op_counts["all-gather"] - len(split) == len(leaves)
    for k in range(4):
        got = tparams.fsdp_gathers(cfg, mesh, k, ws=ws)
        assert got["bytes"] * (RANKS[0] - 1) == priced
        layers = len({p[1] for p in leaves if len(p) == 3})
        assert got["calls"] == cfg.n_repeats * layers + 2


@pytest.mark.parametrize("name,over", SERVED, ids=[n for n, _ in SERVED])
def test_reference_weights_sharded_are_the_seeds_share(name, over):
    """``from_reference`` then ``shard_params`` and ``init_params(share=)``
    give each process of the (2, 2) grid the same leaves, each cut over
    "model" then over "data" where the rule table's shardings split it,
    and ``share_nbytes`` counts them; every leaf the shardings put on
    "data" is cut on its "embed" dim, no other."""
    cfg = tconfigs.get_smoke(name, **over)
    mesh = make_host_mesh(*RANKS)
    whole = tparams.init_params(cfg, 7, "cpu")
    tree = tparams.from_reference({
        "top": {k: v.numpy() for k, v in whole["top"].items()},
        "blocks": tuple({k: v.numpy() for k, v in b.items()}
                        for b in whole["blocks"])}, cfg, "cpu")
    specs = tparams.param_shardings(cfg, mesh, trules.rules_for(cfg))
    axes = tparams.logical_axes(cfg)
    for k in range(4):
        cut = tparams.shard_params(tree, cfg, mesh, k)
        drawn = tparams.init_params(cfg, 7, "cpu", share=(mesh, k))
        for a, b in zip((cut["top"], *cut["blocks"]),
                        (drawn["top"], *drawn["blocks"])):
            for key in a:
                assert torch.equal(a[key], b[key]), (k, key)
        assert tparams.nbytes(cut) == tparams.share_nbytes(cfg, mesh, k)
        data = tparams.data_cuts(cfg, mesh, k)
        items = [((key,), s, axes["top"][key])
                 for key, s in specs["top"].items()]
        items += [(("blocks", i, key), s, axes["blocks"][i][key])
                  for i, b in enumerate(specs["blocks"])
                  for key, s in b.items()]
        on = {}
        for path, s, ax in items:
            dims = [j for j, e in enumerate(s.spec)
                    if "data" in trules.entry_axes(e)]
            if dims:
                on[path] = [ax[j] for j in dims]
        assert set(on) == set(data)
        assert all(v == ["embed"] for v in on.values())


def test_stacked_model_holds_the_leaves_whole_over_data():
    """On one device at (2, 2) the model holds every leaf whole over
    "data" (its model shares stacked, as at (1, 2)) and gathers nothing."""
    cfg = tconfigs.get_smoke(LLAMA)
    tree = tparams.init_params(cfg, 0, "cpu")
    held = TModel(cfg, RANKS, device="cpu").load_params(tree)
    other = TModel(cfg, (1, 2), device="cpu").load_params(tree)
    for a, b in zip((held["top"], *held["blocks"]),
                    (other["top"], *other["blocks"])):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_serve_cli_over_both_axes_gives_the_stacked_tokens(capsys):
    """``serve --data-mesh 2 --model-mesh 2 --backend gloo`` serves
    Llama SMOKE with its weights split over both axes: the stacked CLI's
    tokens, each process's all-gathers of its weights printed."""
    args = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--batch",
            "2", "--prompt-len", "6", "--gen", "3", "--data-mesh", "2",
            "--model-mesh", "2"]
    want = tserve.serve(args)
    got = tserve.serve(args + ["--backend", "gloo"])
    np.testing.assert_array_equal(got, want)
    text = capsys.readouterr().out
    calls = 3 * tparams.fsdp_gathers(tconfigs.get_smoke(LLAMA),
                                     make_host_mesh(2, 2), 0)["calls"]
    assert "2 x 2 ranks as 4 processes over gloo" in text
    assert f"{calls} all-gathers of weights over data" in text


@pytest.mark.parametrize("name,over", SERVED, ids=[n for n, _ in SERVED])
def test_fsdp_serve_matches_stacked_and_reference(pool, name, over):
    """Served over the (2, 2) pool on the JAX package's weights, each
    layer gathered over "data" at its use: the stacked port's tokens and
    prefill logits bit for bit; the JAX package's prefill logits within
    ATOL, RTOL (for Llama and RWKV6 its greedy tokens too); each process
    holds ``share_nbytes`` (a quarter of each expert, half of every
    "embed" dim) and makes ``params.fsdp_gathers`` all-gathers of its
    weights a call, and no staged copy."""
    weights = _weights(name)
    want_tokens, want_logits = _stacked(name, over, weights)
    got = tserve.serve_procs(pool, arch=name, smoke=True, batch=SB,
                             prompt_len=SP, gen=SG, seed=0, ranks=RANKS,
                             weights=weights, **over)
    np.testing.assert_array_equal(got["tokens"], want_tokens)
    assert got["prefill_logits"].tobytes() == want_logits.tobytes()
    if name in MOE:
        ref_logits = _moe_reference_logits(name)
    else:
        ref = _rwkv_reference() if name == RWKV else _dense_reference(name)
        np.testing.assert_array_equal(got["tokens"], ref[1])
        ref_logits = ref[2]
    np.testing.assert_allclose(got["prefill_logits"], ref_logits,
                               atol=ATOL, rtol=RTOL)
    cfg = tconfigs.get_smoke(name, **over)
    mesh = make_host_mesh(*RANKS)
    whole = tparams.nbytes(tparams.from_reference(weights, cfg, "cpu"))
    for k in range(pool.nprocs):
        share = tparams.share_nbytes(cfg, mesh, k)
        assert got["param_bytes"][k] == [share["dense"], share["experts"]]
        assert share["experts"] * 4 == whole["experts"]
        assert share["dense"] < whole["dense"] / 2
        want = _call_gathers(cfg, mesh, k)
        assert {key: got["fsdp_gather"][k][key] for key in want} == want
    assert got["result"].transport["staged_copies"] == 0
