"""Training over processes: ``Model.loss``, the train step and ``launch/
train.py --backend gloo`` with the (data, model) ranks held by a
4-process gloo pool on the CPU, against the stacked training run and the
JAX package.

Process k is mesh rank (i, j) = divmod(k, tp) of a (2, 2) or (1, 4)
grid: it holds, updates and checkpoints only its share (model rank j's
part of the dense layers, data rank i's slice of every "embed" dim, its
e_pad/tp experts: ``params.shard_params``) and its data shard's rows of
each global batch.  Its gradient is its share's of the global batch's
gradient: the tensor-parallel enter and leave over "model", each weight
bucket gathered over "data" reduce-scattered back, the MoE layers'
all-to-alls, gathers and slices each with its transpose, then the leaves
whole over "data" all-reduced and the shared kv heads summed.

Bit identity is not the bar: the processes sum a replicated input's
gradient and the data-parallel gradient in other orders than autograd
does on one program.  So, SMOKE in fp32, 3 steps of a global batch of 4
rows of 16 tokens:

- against the stacked run at the same ranks (one program, the tree held
  whole), on the same parameters before each step (the processes'
  own, joined by ``params.join_shares``): each step's loss and
  grad_norm within rtol 1e-5, and step 0's joined gradients within
  1e-5·max|g| + 1e-4·|g| of the leaf's.  That is ten times the 1e-6·max|g|
  first asked for: a gradient entry is a sum of up to B·S products,
  summed in other orders through every layer, and in the deeper models
  its rounding reaches a few 1e-6 of the leaf's largest (measured:
  Jamba's 8 layers, 216 of 1.95 M entries past 1e-6·max|g| + 1e-4·|g|,
  at most 2.5 times it on the JAX package's weights and 5 times it on
  the seed's; the stacked run's own gradients are 2e-6 to 9e-6 of each
  leaf's largest from the JAX package's, the processes' no farther).
  Each step is
  held on the processes' parameters because a free run drifts:
  AdamW's normalised update turns gradient entries near their
  rounding into ±lr steps, and RWKV6's steps grow it (measured: its
  step-2 grad_norm 4e-4 off in a free run, at every learning rate
  tried, 3e-3 to 1e-4);
- against the JAX package (``jax.value_and_grad`` of its ``Model.loss``
  on the same weights and batch): step 0's loss within ATOL, RTOL, and
  every joined gradient leaf within 3e-4·max|ref| + 3e-3·|ref|; the
  dense models on one CPU device, the MoE models on a (2, 2) mesh of
  four fake devices in a subprocess (the mesh's groups decide what
  drops) that starts with the module's pool and runs beside the tests.

The leaves a process holds whole over "model" get the same gradient on
every model process of its data shard, bit for bit; each step's
collectives are ``params.train_collectives``', and the test names where
they differ from the dry run's prices; a resume over processes is the
straight run bit for bit; decode_ws and fsdp_sp's MoE configs are
refused before any message, the pool staying up.
"""

import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as rconfigs
from repro.data.pipeline import synthetic_batch as ref_synthetic_batch
from repro.models.model import Model as RModel
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.optim import adamw as tadamw
from test_torch_mixer_procs import RWKV4
from test_torch_moe_procs import _mesh, _one_thread, pool4  # noqa: F401

ATOL, RTOL = 3e-4, 3e-3  # fp32 smoke loss, JAX against the port
REF_GRAD = (3e-4, 3e-3)  # a gradient leaf: ·max|ref|, ·|ref|
STACKED_GRAD = (1e-5, 1e-4)  # a gradient leaf against the stacked run
STEP_RTOL = 1e-5  # a step's loss and grad_norm against the stacked run
B, S, STEPS = 4, 16, 3
LLAMA, RWKV, QWEN, JAMBA = ("llama3_8b", "rwkv6_1_6b", "qwen2_moe_a2_7b",
                            "jamba_1_5_large_398b")
NOWS = {"moe_weight_stationary": False}
GEMMA, PIXTRAL, HUBERT = "gemma2_9b", "pixtral_12b", "hubert_xlarge"
# (label, arch, config overrides, (data, model) grid): the four families
# at (2, 2) (the MoE layers weight-stationary at this batch, as the
# reference trains them, and Qwen past it), RWKV6 (4 wkv heads) and
# Llama (two model processes a kv head) at (1, 4); Gemma-2 (softcaps,
# a local window of 6 that masks at S = 16), Pixtral (a vision prefix
# before the tokens) and HuBERT (audio frames, no vocabulary lookup,
# non-causal) at (2, 2)
CASES = (("llama-2x2", LLAMA, {}, (2, 2)),
         ("rwkv4-2x2", RWKV, RWKV4, (2, 2)),
         ("qwen-2x2", QWEN, {}, (2, 2)),
         ("qwen-nows-2x2", QWEN, NOWS, (2, 2)),
         ("jamba-2x2", JAMBA, {}, (2, 2)),
         ("llama-1x4", LLAMA, {}, (1, 4)),
         ("rwkv4-1x4", RWKV, RWKV4, (1, 4)),
         ("gemma2-2x2", GEMMA, {"sliding_window": 6}, (2, 2)),
         ("pixtral-2x2", PIXTRAL, {}, (2, 2)),
         ("hubert-2x2", HUBERT, {}, (2, 2)))
MOE_REFS = (("qwen", QWEN, {}), ("qwen-nows", QWEN, NOWS),
            ("jamba", JAMBA, {}))
# the cases with a frontend, whose reference also runs in the subprocess
# (on step 0's batch as the CLI draws it), beside the tests
FRONT_REFS = (("gemma2", GEMMA, {"sliding_window": 6}),
              ("pixtral", PIXTRAL, {}), ("hubert", HUBERT, {}))


def _argv(arch, ranks, steps=STEPS, *extra):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--data-mesh",
            str(ranks[0]), "--model-mesh", str(ranks[1]), "--steps",
            str(steps), "--batch", str(B), "--seq", str(S), *extra]


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@functools.cache
def _weights(arch, over_key):
    """The JAX package's smoke weights (PRNGKey(0)) as numpy."""
    cfg = rconfigs.get_smoke(arch, **dict(over_key))
    return jax.tree.map(np.asarray,
                        RModel(cfg, _mesh1()).init_params(
                            jax.random.PRNGKey(0)))


def _batch(cfg, step):
    """The global batch of ``step``, as the CLI draws it
    (``train.step_batch``): the pipeline's tokens and labels, a vision
    prefix or audio frames from one numpy stream over the steps."""
    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                               global_batch=B)).batch(step)
    out = {"tokens": b["tokens"], "labels": b["labels"]}
    if not cfg.frontend:
        return out
    rng = np.random.default_rng(1234)
    shape = (B, cfg.n_prefix, cfg.d_model) if cfg.frontend == "vision" \
        else (B, S, cfg.d_model)
    for _ in range(step + 1):
        drawn = rng.standard_normal(shape).astype(np.float32)
    if cfg.frontend == "vision":
        return {**out, "prefix": drawn}
    return {"embeds": drawn, "labels": out["labels"]}


@functools.cache
def _moe_reference():
    """Start the JAX package's ``value_and_grad`` of each MoE model's
    loss on its smoke weights and step 0's batch, jitted on a (2, 2)
    mesh of four fake CPU devices (its scan "native"), in a subprocess,
    then of the ``FRONT_REFS`` cases' on the CLI's step-0 batch (written
    for it first); returns (the process, the file its losses and
    gradients land in)."""
    from repro.launch.mesh import fake_device_env

    tmp = tempfile.mkdtemp(prefix="train-procs-")
    out = os.path.join(tmp, "ref.npz")
    front = os.path.join(tmp, "front.npz")
    np.savez(front, **{f"{key}/{k}": v for key, arch, over in FRONT_REFS
                       for k, v in _batch(tconfigs.get_smoke(arch, **over),
                                          0).items()})
    code = textwrap.dedent(f"""
        import jax, numpy as np
        from jax.sharding import Mesh
        from repro import configs
        from repro.core import scan_api
        from repro.data.pipeline import synthetic_batch
        from repro.models.model import Model

        def mesh(d, m):
            return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                        ("data", "model"))

        got = {{}}
        fronts = dict(np.load({front!r}))
        for key, name, over in {MOE_REFS + FRONT_REFS!r}:
            cfg = configs.get_smoke(name, scan=scan_api.ScanSpec(
                kind="exclusive", algorithm="native"), **over)
            params = Model(cfg, mesh(1, 1)).init_params(
                jax.random.PRNGKey(0))
            batch = synthetic_batch(cfg, {B}, {S}, 0)
            if any(k.startswith(key + "/") for k in fronts):
                batch = {{k.split("/")[1]: v for k, v in fronts.items()
                         if k.startswith(key + "/")}}
            model = Model(cfg, mesh(2, 2))
            with jax.set_mesh(model.mesh):
                (loss, _), grads = jax.jit(jax.value_and_grad(
                    model.loss, has_aux=True))(params, batch)
            got[key + "/loss"] = np.asarray(loss)
            for i, g in enumerate(jax.tree.leaves(grads)):
                got[f"{{key}}/{{i}}"] = np.asarray(g)
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
def _dense_reference(arch, over_key):
    """(loss, gradient leaves) of the JAX package's loss on one CPU
    device, on its smoke weights and step 0's batch."""
    cfg = rconfigs.get_smoke(arch, **dict(over_key))
    model = RModel(cfg, _mesh1())
    params = jax.tree.map(jnp.asarray, _weights(arch, over_key))
    batch = jax.tree.map(jnp.asarray, ref_synthetic_batch(cfg, B, S, 0))
    with jax.set_mesh(model.mesh):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(params, batch)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _reference(arch, over):
    """(loss, gradient leaves) of the JAX package at step 0: the MoE
    models' from the subprocess, the dense ones' in process."""
    over_key = tuple(sorted(over.items()))
    subprocess_refs = MOE_REFS + FRONT_REFS
    if arch not in {a for _, a, _ in subprocess_refs}:
        return _dense_reference(arch, over_key)
    name = next(key for key, a, o in subprocess_refs
                if (a, tuple(sorted(o.items()))) == (arch, over_key))
    proc, out = _moe_reference()
    if proc.returncode is None:
        _, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr
    with np.load(out) as f:
        n = sum(1 for k in f.files if k.startswith(name + "/")) - 1
        return float(f[name + "/loss"]), [f[f"{name}/{i}"]
                                          for i in range(n)]


@pytest.fixture(scope="module")
def pool(pool4):
    """The module's pool; the MoE reference starts beside it."""
    _moe_reference()
    return pool4


_RUNS: dict = {}


def _procs_run(pool, label):
    """The case's 3 steps over the pool from the JAX package's weights:
    ``train_procs`` with step 0's gradients and each step's parameters
    (one run a case, shared by the tests)."""
    if label not in _RUNS:
        _, arch, over, ranks = next(c for c in CASES if c[0] == label)
        _RUNS[label] = ttrain.train_procs(
            pool, _argv(arch, ranks), over=over,
            weights=_weights(arch, tuple(sorted(over.items()))), grads=True,
            params=True, norms=True)
    return _RUNS[label]


def _stacked_step(cfg, ranks, tree, step):
    """The stacked run's (loss, grad_norm, gradient leaves) of ``step``'s
    batch on ``tree`` (a whole parameter tree), on one thread as the
    pool's processes run."""
    model = TModel(cfg, ranks, device="cpu")
    params = model.load_params(tree, trainable=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, step).items()}
    with _one_thread():
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, _tree.leaves(params))
    return float(loss.detach()), float(tadamw.global_norm(grads)), grads


def _close(got, want, atol, rtol, what):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=atol * max(scale, 1e-30), rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("label,arch,over,ranks", CASES,
                         ids=[c[0] for c in CASES])
def test_train_matches_stacked_and_reference(pool, label, arch, over, ranks):
    """3 steps over the pool: each step's loss and grad_norm those of the
    stacked run on the same parameters (rtol 1e-5), step 0's gradients
    joined the stacked run's and the JAX package's, each process holding
    its share and the moments of it alone."""
    got = _procs_run(pool, label)
    cfg = ttrain.config_of(ttrain.parse_args(_argv(arch, ranks)), over)
    mesh = make_host_mesh(*ranks)
    weights = _weights(arch, tuple(sorted(over.items())))
    before = [tparams.from_reference(weights, cfg, "cpu")]
    for k in range(STEPS - 1):  # the processes' parameters after step k
        shares = [_tree.tree_map(lambda a, k=k: a[k], p)
                  for p in got["params"]]
        before.append(tparams.join_shares(shares, cfg, mesh))
    for step, tree in enumerate(before):
        loss, gnorm, grads = _stacked_step(cfg, ranks, tree, step)
        m = got["metrics"][step]
        np.testing.assert_allclose(m["loss"], loss, rtol=STEP_RTOL,
                                   err_msg=f"step {step} loss")
        np.testing.assert_allclose(m["grad_norm"], gnorm, rtol=STEP_RTOL,
                                   err_msg=f"step {step} grad_norm")
        if step == 0:
            stacked = grads
    joined = _tree.leaves(tparams.join_shares(got["grads"], cfg, mesh))
    paths = tparams.leaf_paths(before[0])
    for path, g, w in zip(paths, joined, stacked):
        _close(g.numpy(), w.numpy(), *STACKED_GRAD, f"stacked {path}")
        # the processes' norm of each leaf, every part counted once
        np.testing.assert_allclose(
            got["leaf_norms"]["/".join(map(str, path))],
            float(torch.norm(g.double())), rtol=1e-9, err_msg=str(path))
    ref_loss, ref_grads = _reference(arch, over)
    np.testing.assert_allclose(got["metrics"][0]["loss"], ref_loss,
                               atol=ATOL, rtol=RTOL)
    assert len(ref_grads) == len(joined)
    for path, g, w in zip(paths, joined, ref_grads):
        assert tuple(g.shape) == w.shape, path
        _close(g.numpy(), w, *REF_GRAD, f"reference {path}")
    for k in range(pool.nprocs):
        share = sum(tparams.share_nbytes(cfg, mesh, k).values())
        n = share // 4  # fp32
        assert got["bytes"][k] == {"params": share, "grads": share,
                                   "moments": 8 * n}


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_whole_leaves_get_one_gradient_on_every_model_process(pool, label):
    """The leaves a process holds whole over "model" (the norms, the
    router, the token shifts' μ, ``cm_wr``, ...) are computed alike by
    every model process of a data shard: their gradients are the same
    bits there, with no all-reduce over "model"; so are the kv heads'
    that model processes share, once summed."""
    _, arch, over, ranks = next(c for c in CASES if c[0] == label)
    got = _procs_run(pool, label)
    cfg = ttrain.config_of(ttrain.parse_args(_argv(arch, ranks)), over)
    mesh = make_host_mesh(*ranks)
    tp = ranks[1]
    paths = tparams.leaf_paths(got["grads"][0])
    checked = 0
    for k in range(pool.nprocs):
        cuts = tparams.tp_cuts(cfg, mesh, k)
        shared, group = tparams.kv_shared(cfg, mesh, k)
        first = k - k % tp
        mates = {path: [first + q for q in group] for path in shared}
        for path, g in zip(paths, _tree.leaves(got["grads"][k])):
            others = mates.get(path) if path in cuts else \
                range(first, first + tp)
            for q in others or ():
                want = _tree.leaves(got["grads"][q])[paths.index(path)]
                assert np.array_equal(g, want), (k, q, path)
                checked += 1
    assert checked > pool.nprocs * 4


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_step_collectives_are_train_collectives(pool, label):
    """Every process's collectives in each step, by kind (calls and the
    bytes it puts in), are ``params.train_collectives``'."""
    _, arch, over, ranks = next(c for c in CASES if c[0] == label)
    got = _procs_run(pool, label)
    cfg = ttrain.config_of(ttrain.parse_args(_argv(arch, ranks)), over)
    mesh = make_host_mesh(*ranks)
    for k, steps in enumerate(got["collectives"]):
        want = tparams.train_collectives(cfg, mesh, k, batch=B, seq=S)
        assert len(steps) == STEPS
        for step in steps:
            assert {kind: {"calls": c["calls"], "bytes": c["bytes"]}
                    for kind, c in step.items()} == want, (k, step)


def test_train_collectives_against_the_dry_run():
    """Llama SMOKE's train cell at (2, 2): what a process moves
    (``train_collectives``) against what the dry run prices for a rank
    (``collectives_of(train=True)``), the deviations named: the weights
    go as one bucket a layer (and one for the embedding, one for the
    head) where the dry run prices one gather and one reduce-scatter a
    stacked leaf; the row-split products' all-reduces are the dry
    run's three (forward, recomputed, backward), the backward one the
    enter of the layer's input, plus the lookup's, the head input's
    enter and the CE's sums over "data"; the CE's (2, B, S) gather over
    "model" and the gradient sync of the leaves whole over "data" and
    the norm's all-reduce, which the dry run does not price.  The dry
    run's recompute is its trace's: torch's checkpoint stops a repeat's
    recompute at its last saved tensor, before w_down's all-reduce,
    where the processes recompute the whole repeat."""
    cfg = tconfigs.get_smoke(LLAMA)
    mesh = make_host_mesh(2, 2)
    shape = tsteps.ShapeSpec("train_b4_s16", "train", S, B)
    coll = tsteps.lower_cell(cfg, shape, mesh).compile().collectives()
    got = tparams.train_collectives(cfg, mesh, 0, batch=B, seq=S)
    r, layers = cfg.n_repeats, len(cfg.pattern())
    stacked = len([p for p in tparams.data_cuts(cfg, mesh, 0)
                   if len(p) == 3])
    top = len([p for p in tparams.data_cuts(cfg, mesh, 0) if len(p) == 1])
    # the gathers: one a stacked leaf, twice under remat, and a top leaf's
    assert coll.op_counts["all-gather"] == 2 * stacked + top
    assert got["fsdp_gather"]["calls"] == 2 * r * layers + top
    # the scatters: one a leaf against one a bucket
    assert coll.op_counts["reduce-scatter"] == stacked + top
    assert got["fsdp_scatter"]["calls"] == r * layers + top
    # each row-split product (wo, w_down) three times, a layer
    priced = coll.op_counts["all-reduce"]
    assert priced == 2 * 2 * r + r  # w_down left out of each recompute
    assert got["all_reduce"]["calls"] == 3 * 2 * r + 1 + 1 + 1
    assert got["all_gather"]["calls"] == 1  # the CE's pair
    assert (got["grad_sync"]["calls"], got["grad_norm"]["calls"]) == (1, 1)
    for kind in ("all_to_all", "reduce_scatter", "kv_sync"):
        assert got[kind]["calls"] == 0, kind


def test_resume_over_processes_is_bit_for_bit(pool, tmp_path):
    """2 steps and a checkpoint of every process's share and moments,
    then a resume that runs step 2, against 3 straight steps: the same
    metrics and parameters, bit for bit (Qwen, (2, 2))."""
    ranks = (2, 2)
    straight = ttrain.train_procs(pool, _argv(QWEN, ranks), params=True)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = ttrain.train_procs(pool, _argv(QWEN, ranks, 2, *ck))
    assert len(first["metrics"]) == 2
    assert sorted(os.listdir(tmp_path / "step_00000002")) == [
        "COMMITTED", "manifest.json",
        *sorted(f"share_{k:05d}.{ext}" for k in range(4)
                for ext in ("json", "npz"))]
    resumed = ttrain.train_procs(pool, _argv(QWEN, ranks, 3, *ck),
                                 params=True)
    assert len(resumed["metrics"]) == 1
    assert first["metrics"] == straight["metrics"][:2]
    assert resumed["metrics"][0] == straight["metrics"][2]
    for got, want in zip(resumed["params"], straight["params"]):
        for a, b in zip(_tree.leaves(got), _tree.leaves(want)):
            assert a[-1].tobytes() == b[-1].tobytes()


def test_store_over_processes_keeps_each_share(tmp_path):
    """``n_hosts`` > 1 writes each process's share under its rank;
    process 0 commits the step once every share is there, each process
    restores its own share bit for bit, and another process count is
    refused.  One host keeps the reference's format."""
    shares = [{"w": torch.full((k + 1, 3), float(k), dtype=torch.bfloat16),
               "m": np.arange(k + 2, dtype=np.float32)} for k in range(2)]
    stores = [CheckpointStore(str(tmp_path), host_id=k, n_hosts=2)
              for k in range(2)]
    stores[1].save(4, shares[1])
    assert stores[0].latest_step() is None  # not committed yet
    stores[0].save(4, shares[0])
    assert stores[0].latest_step() == 4
    for store, share in zip(stores, shares):
        got = store.restore(4, share)
        assert np.asarray(got["m"]).tobytes() == share["m"].tobytes()
        assert torch.equal(torch.from_numpy(
            np.asarray(got["w"]).view(np.int16)),
            share["w"].view(torch.int16))
    with pytest.raises(ValueError, match="checkpoint of 2 processes"):
        CheckpointStore(str(tmp_path), host_id=0, n_hosts=4).restore(
            4, shares[0])
    one = CheckpointStore(str(tmp_path / "one"))
    one.save(1, shares[0])
    assert sorted(os.listdir(tmp_path / "one" / "step_00000001")) == [
        "COMMITTED", "manifest.json", "shard_00000.npz"]


def test_refusals_over_processes(pool):
    """What training over processes still refuses, in every process
    before any message, naming its reason, the pool staying up:
    training under decode_ws (the activations' d over "data" under
    autograd, ROADMAP Queue 1 item 2.3.1; decode_ws serves over
    processes: ``tests/test_torch_decode_ws_procs.py``) and
    the MoE configs under fsdp_sp (the reference's decision: "experts"
    and "embed" both over "model"); a call with a cache under fsdp_sp
    (Queue 1 item 2.4) is refused on the serving path.  ``--autotune``
    with ``--backend`` and fsdp_sp's loss now train
    (``tests/test_torch_fsdp_sp_procs.py``)."""
    argv = _argv(QWEN, (2, 2), 1)
    for arch, over, match in ((QWEN, {"sharding_strategy": "fsdp_sp"},
                               "ValueError: .*'model'"),
                              (QWEN, {"sharding_strategy": "decode_ws"},
                               "NotImplementedError: training under "
                               "decode_ws .*Queue 1 item 2.3.1")):
        with pytest.raises(RuntimeError, match=match):
            ttrain.train_procs(pool, _argv(arch, (2, 2), 1), over=over)
    with pytest.raises(RuntimeError, match="NotImplementedError: a call "
                                           "with a cache under fsdp_sp"):
        pool.call("serve", None, arch=RWKV, smoke=True, batch=4,
                  prompt_len=8, gen=1, ranks=(2, 2), mesh=_mesh((2, 2)),
                  sharding_strategy="fsdp_sp", **RWKV4)
    assert len(ttrain.train_procs(pool, argv)["metrics"]) == 1


def test_train_cli_over_processes(capsys):
    """``train --backend gloo --data-mesh 2 --model-mesh 2`` trains Qwen
    SMOKE over four processes: the stacked CLI's losses (the same
    weights from the seed; rtol 1e-5), each process's bytes and a step's
    collectives printed."""
    argv = _argv(QWEN, (2, 2))
    want = ttrain.train(argv)
    got = ttrain.train(argv + ["--backend", "gloo"])
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    text = capsys.readouterr().out
    cfg = tconfigs.get_smoke(QWEN)
    share = sum(tparams.share_nbytes(cfg, make_host_mesh(2, 2), 0).values())
    assert "2 x 2 ranks as 4 processes over gloo" in text
    assert f"process 0: parameters {share} B, gradients {share} B" in text
    assert "all_to_all" in text and "fsdp_scatter" in text


@pytest.mark.parametrize("ranks", [(2, 2), (1, 4)],
                         ids=lambda r: f"{r[0]}x{r[1]}")
def test_train_cli_autotune_over_processes(capsys, ranks):
    """``train --backend gloo --autotune --autotune-every 1`` trains
    Llama SMOKE over four processes: the stacked CLI's losses with
    ``--autotune`` (rtol 1e-5), and the installs every process made
    alike printed: none in two steps under the default gate, as the
    stacked CLI installs none.  The probe runs over the "data" processes
    at (2, 2) and, one data process leaving p = 2 no group, stacked on
    each process's device at (1, 4).  ``tests/test_torch_fsdp_sp_procs.py``
    opens the gate and holds the installs themselves."""
    argv = _argv(LLAMA, ranks, 2, "--autotune", "--autotune-every", "1")
    want = ttrain.train(argv)
    stacked = capsys.readouterr().out
    assert "[autotune] refits=0 installs=0" in stacked
    got = ttrain.train(argv + ["--backend", "gloo"])
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    text = capsys.readouterr().out
    assert f"{ranks[0]} x {ranks[1]} ranks as 4 processes over gloo" in text
    assert len([ln for ln in text.splitlines()
                if ln.startswith("step ")]) == 2
    assert "[autotune] installs (step, fingerprint) on every process: []" \
        in text
