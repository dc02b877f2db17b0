"""Models served under the decode_ws strategy over processes, on the
4-process gloo pool on the CPU as the (2, 2) and the (4, 1) grid, against
the stacked port's decode_ws twin and the JAX package.

decode_ws (``DECODE_WS_RULES``) keeps every weight where FSDP put it,
data rank i's slice of each leaf's "embed" dim (``params.data_cuts``),
and never gathers it; the activations carry d over "data" instead
("embed_act"): process (i, j) holds every row's d-slice i, the batch
replicated over "data".  A product from d is a partial summed over
"data" (``shards.ProcessSlice``: one all-reduce a group of products,
counted as "ws_reduce"), a norm's sums of squares are summed so, a
product into d writes the slice; each mixer's core runs on the rows its
cache holds (data shard i's: "cache_batch" over "data") and comes back
to every row (an all-gather, "ws_gather").  The stacked model loaded for
serving at n_data > 1 computes the same slices and sums them in the
same order (``shards.StackedSlices``), so tokens and logits are the
processes' bit for bit (both on one thread).  Against the JAX package's
decode_ws, jitted on a (2, 2) mesh of four fake CPU devices in two
subprocesses started with the module's pool, on the same weights
(``params.from_reference``): logits within ATOL, RTOL and the greedy
tokens equal.  HuBERT (audio frames, no vocabulary lookup, no decode) is
held by its forward.
"""

import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
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
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.models.shards import StackedSlices
from test_torch_mixer_procs import RWKV4
from test_torch_moe_procs import _mesh, _one_thread, pool4  # noqa: F401

ATOL, RTOL = 3e-4, 3e-3  # fp32 smoke logits, JAX against the port
DWS = {"sharding_strategy": "decode_ws"}
GRIDS = ((2, 2), (4, 1))
SB, SP, SG = 4, 8, 4  # requests, prompt tokens, generated tokens
# (label, arch, config overrides): RWKV6 with 4 wkv heads, Pixtral (a
# vision prefix before the prompts), HuBERT (audio frames, forward only)
CASES = (("llama", "llama3_8b", {}), ("qwen", "qwen2_moe_a2_7b", {}),
         ("jamba", "jamba_1_5_large_398b", {}), ("gemma2", "gemma2_9b", {}),
         ("rwkv4", "rwkv6_1_6b", RWKV4), ("pixtral", "pixtral_12b", {}),
         ("hubert", "hubert_xlarge", {}))
LABELS = [c[0] for c in CASES]
MOE = ("qwen", "jamba")
# the reference's subprocesses, each a share of the cases (about 20 s
# each on the CPU: Jamba's jit alone takes 17 s)
REF_GROUPS = (("jamba", "gemma2", "pixtral", "hubert"),
              ("llama", "qwen", "rwkv4"))


def _case(label):
    return next(c for c in CASES if c[0] == label)


def _cfg(label):
    _, arch, over = _case(label)
    return tconfigs.get_smoke(arch, **DWS, **over)


def _prefix(cfg):
    """A vision model's patch embeddings, an audio model's frames (SP of
    them), else None: (SB, n, d) fp32 from seed 1."""
    n = cfg.n_prefix if cfg.frontend == "vision" else \
        SP if cfg.frontend == "audio" else 0
    if not n:
        return None
    return np.random.default_rng(1).standard_normal(
        (SB, n, cfg.d_model)).astype(np.float32)


@functools.cache
def _reference(group):
    """Start the JAX package's decode_ws run of ``group``'s cases in a
    subprocess on a (2, 2) mesh of four fake CPU devices, its scan
    "native" (``test_torch_fsdp_procs``' recipe), on each case's smoke
    weights from PRNGKey(0): prefill with ``last_only`` and SG − 1
    greedy decode steps (the last-position logits of the prefill and the
    tokens), HuBERT's forward on its frames.  Returns (the process, the
    file its results land in)."""
    from repro.launch.mesh import fake_device_env

    out = os.path.join(tempfile.mkdtemp(prefix="dws-procs-"), "ref.npz")
    cases = [c for c in CASES if c[0] in group]
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro import configs
        from repro.core import scan_api
        from repro.models.model import Model

        def mesh(d, m):
            return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                        ("data", "model"))

        B, P, G = {SB}, {SP}, {SG}
        got = {{}}
        for label, name, over in {cases!r}:
            cfg = configs.get_smoke(name, scan=scan_api.ScanSpec(
                kind="exclusive", algorithm="native"),
                sharding_strategy="decode_ws", **over)
            params = Model(cfg, mesh(1, 1)).init_params(
                jax.random.PRNGKey(0))
            model = Model(cfg, mesh(2, 2))
            n = cfg.n_prefix if cfg.frontend == "vision" else \\
                P if cfg.frontend == "audio" else 0
            pre = jnp.asarray(np.random.default_rng(1).standard_normal(
                (B, n, cfg.d_model)).astype(np.float32)) if n else None
            prompts = jnp.asarray(np.random.default_rng(0).integers(
                1, cfg.vocab, (B, P)).astype(np.int32))
            with jax.set_mesh(model.mesh):
                if cfg.encoder_only:
                    logits, _ = jax.jit(model.forward)(params, None, pre)
                    got[label + "/logits"] = np.asarray(logits)
                    continue
                cache = model.init_cache(B, P + n + G)
                logits, cache = jax.jit(lambda p, c, t, e: model.serve_step(
                    p, c, t, 0, prefix_embeds=e, last_only=True))(
                    params, cache, prompts, pre)
                got[label + "/logits"] = np.asarray(logits[:, -1])
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                out = [tok]
                decode = jax.jit(model.decode_step)
                for i in range(G - 1):
                    logits, cache = decode(params, cache, tok[:, None],
                                           P + n + i)
                    tok = jnp.argmax(logits[:, -1],
                                     axis=-1).astype(jnp.int32)
                    out.append(tok)
                got[label + "/tokens"] = np.stack(
                    [np.asarray(t) for t in out], axis=1)
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
def _reference_out(group):
    proc, out = _reference(group)
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _reference_of(label):
    group = next(g for g in REF_GROUPS if label in g)
    got = _reference_out(group)
    return got.get(label + "/tokens"), got[label + "/logits"]


@pytest.fixture(scope="module")
def pool(pool4):
    """The module's pool; the references start beside it."""
    for group in REF_GROUPS:
        _reference(group)
    return pool4


@functools.cache
def _weights(label):
    """The JAX package's smoke weights of the case from PRNGKey(0), as
    numpy (the tree its subprocesses draw)."""
    _, arch, over = _case(label)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    model = RModel(rconfigs.get_smoke(arch, **DWS, **over), mesh)
    return jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))


@functools.cache
def _stacked(label, ranks):
    """The stacked decode_ws twin at ``ranks`` on the case's weights (one
    thread, as the pool's processes run): (served tokens, the prefill's
    last logits), or for HuBERT (None, its forward's logits)."""
    cfg = _cfg(label)
    model = TModel(cfg, ranks, device="cpu")
    params = model.load_params(tparams.from_reference(_weights(label), cfg,
                                                      "cpu"))
    assert isinstance(model.dsl, StackedSlices)
    prefix = _prefix(cfg)
    with _one_thread():
        if cfg.encoder_only:
            logits, _ = model.forward(params, None,
                                      prefix_embeds=torch.from_numpy(prefix))
            return None, logits.numpy()
        res = tserve.serve_loop(model, params,
                                tserve.prompts_for(cfg, SB, SP, 0), SG,
                                prefix)
    return res.tokens, res.prefill_logits.numpy()


_RUNS: dict = {}


def _procs(pool, label, ranks):
    """The case served over the pool as ``ranks`` (HuBERT: its forward),
    one run a case: (tokens or None, logits, the ``DistResult``)."""
    key = (label, ranks)
    if key not in _RUNS:
        _, arch, over = _case(label)
        cfg = _cfg(label)
        kw = dict(arch=arch, smoke=True, batch=SB, prompt_len=SP, gen=SG,
                  seed=0, ranks=ranks, weights=_weights(label),
                  prefix=_prefix(cfg), **DWS, **over)
        if cfg.encoder_only:
            res = pool.call("serve", None, forward=True, mesh=_mesh(ranks),
                            **kw)
            for k in range(1, pool.nprocs):  # every process every row
                assert res.outputs[0][k].tobytes() == \
                    res.outputs[0][0].tobytes()
            _RUNS[key] = (None, res.outputs[0][0], res)
        else:
            got = tserve.serve_procs(pool, **kw)
            _RUNS[key] = (got["tokens"], got["prefill_logits"],
                          got["result"])
    return _RUNS[key]


def _calls(cfg, mesh, k, *, forward: bool) -> dict:
    """Process k's collectives of the run, by executor kind: a prefill
    and SG − 1 decode steps (``params.ws_collectives`` a call), or one
    forward; {kind: [calls, bytes]}."""
    n = 0 if _prefix(cfg) is None or cfg.frontend == "audio" \
        else cfg.n_prefix
    runs = ((SP, 1, False),) if forward else \
        ((SP + n, 1, True), (1, SG - 1, True))
    out: dict = {}
    for seq, times, last in runs:
        got = tparams.ws_collectives(cfg, mesh, k, batch=SB, seq=seq,
                                     last_only=last,
                                     prefix=n if seq > 1 else 0)
        for (kind, _), v in got.items():
            t = out.setdefault(kind, [0, 0])
            t[0] += times * v["calls"]
            t[1] += times * v["bytes"]
    return out


@pytest.mark.parametrize("ranks", GRIDS, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("label", LABELS)
def test_decode_ws_over_processes_is_the_stacked_twin(pool, label, ranks):
    """Served under decode_ws over the pool (HuBERT: its forward), on
    the JAX package's weights: the stacked twin's tokens and logits bit
    for bit; each process holds ``share_nbytes`` (its FSDP share) and
    gathers no dense weight, and its collectives, counted by the
    executor by kind, are ``params.ws_collectives``' (the dispatch
    scans' messages aside)."""
    tokens, logits, res = _procs(pool, label, ranks)
    want_tokens, want_logits = _stacked(label, ranks)
    if tokens is not None:
        np.testing.assert_array_equal(tokens, want_tokens)
    assert logits.tobytes() == want_logits.tobytes()
    cfg = _cfg(label)
    mesh = make_host_mesh(*ranks)
    kinds = ("all_reduce", "all_gather", "all_to_all", "fsdp_gather",
             *tsch.WS_KINDS)
    for k, t in enumerate(res.traffic):
        share = tparams.share_nbytes(cfg, mesh, k)
        if tokens is not None:
            assert res.outputs[3][k].tolist() == [share["dense"],
                                                  share["experts"]]
        want = _calls(cfg, mesh, k, forward=tokens is None)
        got = {kind: [t[kind], t[kind + "_bytes"]] for kind in kinds
               if t[kind]}
        assert got == {kind: v for kind, v in want.items() if v[0]}
        # the weights stay put: only a MoE call that is not
        # weight-stationary gathers (its experts), none here
        assert t["fsdp_gather"] == 0
    assert res.transport["staged_copies"] == 0


@pytest.mark.parametrize("label", LABELS)
def test_decode_ws_over_processes_matches_the_reference(pool, label):
    """Against the JAX package's decode_ws on a (2, 2) mesh of four fake
    devices: the (2, 2) run's logits within ATOL, RTOL and its greedy
    tokens equal; the dense models' (4, 1) run too (the MoE layers group
    their tokens by the mesh, so another mesh drops others)."""
    ref_tokens, ref_logits = _reference_of(label)
    grids = GRIDS[:1] if label in MOE else GRIDS
    for ranks in grids:
        tokens, logits, _ = _procs(pool, label, ranks)
        np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=RTOL)
        if tokens is not None:
            np.testing.assert_array_equal(tokens, ref_tokens)


def test_moe_prefill_past_weight_stationary_gathers_its_experts(pool):
    """A Qwen call that is not weight-stationary (B·S·k past 4096, or
    ``moe_weight_stationary`` off) runs its MoE layers on whole-d tokens:
    each process gathers its experts over "data" (one bucket a layer,
    ``params.fsdp_gathers``), joins its tokens' d and gathers y's rows
    back (``ws_gather``); tokens and logits the twin's bit for bit, the
    collectives ``ws_collectives``'."""
    over = {"moe_weight_stationary": False}
    cfg = tconfigs.get_smoke("qwen2_moe_a2_7b", **DWS, **over)
    mesh = make_host_mesh(2, 2)
    model = TModel(cfg, (2, 2), device="cpu")
    params = model.load_params(tparams.from_reference(_weights("qwen"), cfg,
                                                      "cpu"))
    with _one_thread():
        want = tserve.serve_loop(model, params,
                                 tserve.prompts_for(cfg, SB, SP, 0), SG)
    got = tserve.serve_procs(pool, arch="qwen2_moe_a2_7b", smoke=True,
                             batch=SB, prompt_len=SP, gen=SG, seed=0,
                             ranks=(2, 2), weights=_weights("qwen"), **DWS,
                             **over)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    assert got["prefill_logits"].tobytes() == \
        want.prefill_logits.numpy().tobytes()
    for k, t in enumerate(got["result"].traffic):
        want_k = _calls(cfg, mesh, k, forward=False)
        assert [t["fsdp_gather"], t["fsdp_gather_bytes"]] == \
            want_k["fsdp_gather"]
        assert [t["ws_gather"], t["ws_gather_bytes"]] == \
            want_k["ws_gather"]
        g = tparams.fsdp_gathers(cfg, mesh, k)
        assert g["calls"] == cfg.n_repeats  # one MoE layer a repeat
        whole = tparams.fsdp_gathers(cfg, mesh, k, ws=False)["buckets"]
        assert g["buckets"] == whole


@pytest.mark.parametrize("label", ["rwkv4", "jamba"])
def test_bf16_serve_counts_its_bytes(pool, label):
    """In bf16 (the chip's rows' dtype; the smoke configs are fp32) each
    collective moves the activations' dtype, so the bytes the executor
    counts are ``ws_collectives``' there too; tokens and logits the
    twin's bit for bit (weights drawn from the seed)."""
    _, arch, over = _case(label)
    bf16 = dict(over, dtype="bfloat16")
    cfg = tconfigs.get_smoke(arch, **DWS, **bf16)
    model = TModel(cfg, (2, 2), device="cpu")
    params = model.init_params(0)
    with _one_thread():
        want = tserve.serve_loop(model, params,
                                 tserve.prompts_for(cfg, SB, SP, 0), SG)
    got = tserve.serve_procs(pool, arch=arch, smoke=True, batch=SB,
                             prompt_len=SP, gen=SG, seed=0, ranks=(2, 2),
                             **DWS, **bf16)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    assert got["prefill_logits"].tobytes() == \
        want.prefill_logits.float().numpy().tobytes()
    mesh = make_host_mesh(2, 2)
    kinds = ("all_reduce", "all_gather", "all_to_all", "fsdp_gather",
             *tsch.WS_KINDS)
    for k, t in enumerate(got["result"].traffic):
        want_k = _calls(cfg, mesh, k, forward=False)
        assert {kind: [t[kind], t[kind + "_bytes"]] for kind in kinds
                if t[kind]} == {kind: v for kind, v in want_k.items()
                                if v[0]}


def test_stacked_slices_sum_in_data_order():
    """``StackedSlices``: a product from d is each slice's partial summed
    in data order in fp32 and cast once, a product into d the slices
    joined, a norm's sum of squares by slice; within fp32 rounding of
    the whole products."""
    rng = np.random.default_rng(5)
    x, w, o = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 5, 16), (16, 6), (6, 16)))
    dsl = StackedSlices(2)
    (got,) = dsl.dots([(x, w)])
    want = ((x[..., :8].contiguous() @ w[:8]).float()
            + (x[..., 8:].contiguous() @ w[8:]).float())
    assert torch.equal(got, want)
    (tied,) = dsl.dots([(x, w.T.contiguous(), True)])
    assert torch.equal(tied, got)
    h = x[..., :6]
    assert torch.equal(dsl.out(h, o), torch.cat(
        [h @ o[:, :8].contiguous(), h @ o[:, 8:].contiguous()], -1))
    ss = dsl.sum_sq(x)
    assert torch.equal(ss, torch.sum(x[..., :8] ** 2, -1, keepdim=True)
                       + torch.sum(x[..., 8:] ** 2, -1, keepdim=True))
    torch.testing.assert_close(got, x @ w, atol=1e-5, rtol=1e-5)
    assert dsl.blocks(4) == [(0, 2), (2, 4)] and dsl.blocks(3) == [(0, 3)]


@pytest.mark.parametrize("label", ["llama", "rwkv4"])
def test_batch_the_data_processes_do_not_split(pool, label):
    """B = 3 rows at (2, 2): no data process can hold a share of the
    rows, so each cache holds every row (the reference's
    ``divisible_spec`` leaves "cache_batch" whole) and the cores run on
    every row, nothing gathered back; tokens and logits the twin's bit
    for bit, no "ws_gather" made."""
    _, arch, over = _case(label)
    cfg = _cfg(label)
    model = TModel(cfg, (2, 2), device="cpu")
    params = model.load_params(tparams.from_reference(_weights(label), cfg,
                                                      "cpu"))
    assert model.cache_rows(3) == slice(0, 3)
    with _one_thread():
        want = tserve.serve_loop(model, params,
                                 tserve.prompts_for(cfg, 3, SP, 0), SG)
    got = tserve.serve_procs(pool, arch=arch, smoke=True, batch=3,
                             prompt_len=SP, gen=SG, seed=0, ranks=(2, 2),
                             weights=_weights(label), **DWS, **over)
    np.testing.assert_array_equal(got["tokens"], want.tokens)
    assert got["prefill_logits"].tobytes() == \
        want.prefill_logits.numpy().tobytes()
    assert all(t["ws_gather"] == 0 for t in got["result"].traffic)


# (name, shape): decode_ws cells of the dry run at (2, 2): Llama's and
# Qwen's decode step (Qwen's MoE weight-stationary)
CELLS = (("llama3_8b", tsteps.ShapeSpec("decode_b4_s16", "decode", 16, 4)),
         ("qwen2_moe_a2_7b",
          tsteps.ShapeSpec("decode_b4_s16", "decode", 16, 4)))


@pytest.mark.parametrize("name,shape", CELLS, ids=[n for n, _ in CELLS])
def test_ws_collectives_name_each_difference_from_the_dry_run(name, shape):
    """The dry run's decode_ws price (``roofline.collectives_of``)
    against the processes' collectives of the same call
    (``ws_collectives``), difference by difference:

    (a) it prices an FSDP all-gather of every leaf the shardings split
        over "data" (the experts aside in a weight-stationary call);
        the processes gather none: the weights never move;
    (b) its all-reduces over "model" are the row-split projections';
        the processes make those and the embedding lookup's;
    (c) it prices a weight-stationary MoE layer's (g, u) and output
        psums over "data" (two); the processes all-reduce the (g, u)
        partials alone, the output staying in its slice;
    (d) the processes' all-reduces over "data" of the partial products
        from d and of the norms' sums of squares, and each core's rows
        gathered back over "data", are not priced;
    (e) nor is the logits' vocabulary gather over "model", nor the MoE
        metrics' gather;
    (f) the all-to-alls are its, in count; each moves the (e_pad·cap,
        d/n_data) slice of the buffer it prices whole in d."""
    cfg = tconfigs.get_smoke(name, **DWS)
    mesh = make_host_mesh(2, 2)
    D, tp = 2, 2
    comp = tsteps.lower_cell(cfg, shape, mesh).compile()
    coll = comp.collectives()
    notes = [c[0] for c in comp.constraints]
    ws = any(n.startswith("moe.ws") for n in notes)
    n_moe = cfg.n_repeats * sum(s.use_moe for s in cfg.pattern())
    assert ws == bool(n_moe)
    got = tparams.ws_collectives(cfg, mesh, 0, batch=shape.batch, seq=1)

    def calls(kind, axis):
        return got.get((kind, axis), {"calls": 0})["calls"]

    # (a)
    leaves = [p for p in tparams.data_cuts(cfg, mesh, 0)
              if not (ws and tparams.is_expert_leaf(p[-1]))]
    split_notes = notes.count("moe.token_split")
    assert coll.op_counts["all-gather"] == len(leaves) + split_notes
    assert calls("fsdp_gather", "data") == 0
    # (b), (c)
    tp_priced = coll.op_counts["all-reduce"] - 2 * n_moe
    assert notes.count("moe.ws_gate_up") == notes.count("moe.ws_out") \
        == n_moe
    assert calls("all_reduce", "model") == tp_priced + int(
        tparams.plan_split(cfg, mesh).vocab)
    # (c), (d): a layer's norms (2), attention's q|k|v, the dense FFN's
    # gate|up or the router, the shared experts' gate|up and the MoE
    # (g, u) partials; the final norm and the head
    per_layer = 4 + (1 if n_moe and cfg.n_shared_experts else 0) + \
        (1 if n_moe else 0)
    assert calls("ws_reduce", "data") == per_layer * cfg.n_repeats + 2
    assert calls("ws_gather", "data") == cfg.n_repeats  # attention's rows
    # (e): the logits' vocabulary; a MoE layer's y (token split) and its
    # metrics, the token split's two priced notes a layer
    assert calls("all_gather", "model") == 1 + 2 * n_moe
    assert split_notes == 2 * n_moe
    # (f)
    if n_moe:
        a2a = got["all_to_all", "model"]
        assert coll.op_counts["all-to-all"] == a2a["calls"] == 2 * n_moe
        assert coll.op_bytes["all-to-all"] == \
            a2a["bytes"] * D * (tp - 1) / tp


def test_one_pool_holds_blocks_of_another_size(pool):
    """The pool's ``p_intra`` set between requests: the same four
    processes hold two ranks each, an 8-rank exclusive xor scan (its
    executor one of that block size) bit for bit the numpy fold, then
    one rank each again for the next request."""
    from repro_torch.core.scan_api import ScanSpec, plan

    x = np.random.default_rng(11).integers(0, 1 << 30, (8, 5),
                                           dtype=np.int64)
    want = np.zeros_like(x)
    for r in range(1, 8):
        want[r] = want[r - 1] ^ x[r - 1]
    pool.p_intra = 2
    try:
        assert pool.p == 8
        pl = plan(ScanSpec(kind="exclusive", monoid="xor",
                           algorithm="123"), 8, nbytes=8 * 5)
        got = pool.run(pl.schedule(), x, monoid="xor")
    finally:
        pool.p_intra = 1
    np.testing.assert_array_equal(got.outputs, want)
    assert pool.p == 4
