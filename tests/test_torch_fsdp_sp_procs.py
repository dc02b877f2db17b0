"""fsdp_sp over processes: the sequence split over the "model" processes,
FSDP over the whole (data, model) grid, on a 4-process gloo pool on the
CPU, against the JAX package and the stacked port.

Process k = mesh rank (i, j) of a (1, 4) or (2, 2) grid holds data shard
i's rows and positions [j·S/tp, (j+1)·S/tp) of each, and its 1/(n_data·tp)
slice of every "embed" dim (``FSDP_SP_RULES`` put "embed" over the whole
grid; nothing is cut over "model" alone).  Each layer's slices are
gathered over every process at their use and reduce-scattered back;
attention gathers k and v over "model"; RWKV6's token shifts read the
previous shard's last row, and its wkv carry across the shards is the
paper's exclusive scan over the "model" processes of the data rank, in
messages, forward and (mirrored) backward.

Held, SMOKE in fp32, B = 4 rows of S = 16 (Pixtral: 4 prefix positions
more):

- ``Model.loss`` and its gradients, and ``Model.forward``'s logits at
  the positions a process holds (the pool entry ``loss``), against the
  JAX package's single-device ``value_and_grad`` and forward, the
  reference's rule that fsdp_sp computes the single-device result
  (``tests/test_torch_cp_train.py``): the loss within ATOL, RTOL, each
  joined gradient leaf within ``REF_GRAD``; and against the stacked
  port's fsdp_sp run on the same weights within ``STACKED`` (the
  processes sum the gradients in other orders);
- the carry's rounds and point-to-point messages against its plan at
  p = tp; a shard boundary's label; two steps of ``train`` over the
  pool against the stacked run; ``--autotune`` over processes; the
  step's collectives against the dry run's price; and the refusals.
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
from repro.models.model import Model as RModel
from repro_torch import _tree
from repro_torch import configs as tconfigs
from repro_torch.core import schedule as tsch
from repro_torch.core.autotune import DriftGate
from repro_torch.core.scan_api import plan
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import context_parallel as tcp
from repro_torch.models import params as tparams
from repro_torch.models.model import Model as TModel
from repro_torch.models.rwkv import HEAD_DIM
from repro_torch.models.shards import SeqShard
from repro_torch.sharding import rules as trules
from test_torch_mixer_procs import RWKV4
from test_torch_moe_procs import _mesh, _one_thread, pool4  # noqa: F401

ATOL, RTOL = 3e-4, 3e-3  # fp32 smoke loss, JAX against the port
REF_GRAD = (3e-4, 3e-3)  # a gradient leaf or logit: ·max|ref|, ·|ref|
STACKED = (1e-5, 1e-4)  # against the stacked port: ·max|g|, ·|g|
STEP_RTOL = 1e-5  # a step's loss against the stacked run
B, S = 4, 16
FSDP_SP = {"sharding_strategy": "fsdp_sp"}
RWKV, LLAMA, QWEN = "rwkv6_1_6b", "llama3_8b", "qwen2_moe_a2_7b"
# (label, arch, config overrides): RWKV6 with 4 wkv heads, Llama (GQA),
# Gemma-2 with its local window cut to 6 so that it masks at S = 16,
# Pixtral (a vision prefix before the tokens), HuBERT (audio frames,
# non-causal)
ARCHS = (("rwkv4", RWKV, RWKV4), ("llama", LLAMA, {}),
         ("gemma2", "gemma2_9b", {"sliding_window": 6}),
         ("pixtral", "pixtral_12b", {}), ("hubert", "hubert_xlarge", {}))
LAYOUTS = ((1, 4), (2, 2))


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _inputs(batch):
    """(tokens, prefix) of a batch as ``forward`` takes them."""
    return batch.get("tokens"), batch.get("embeds", batch.get("prefix"))


@functools.cache
def _reference(label):
    """The JAX package's smoke model on its (1, 1) mesh: weights, the
    global batch, loss, gradient leaves and the forward's logits."""
    _, arch, over = next(a for a in ARCHS if a[0] == label)
    cfg = rconfigs.get_smoke(arch, **over)
    model = RModel(cfg, _mesh1())
    params = model.init_params(jax.random.PRNGKey(0))
    batch = {k: np.asarray(v)
             for k, v in ref_synthetic_batch(cfg, B, S, 0).items()}

    def both(p, b):
        got = jax.value_and_grad(model.loss, has_aux=True)(p, b)
        return got, model.forward(p, *_inputs(b))[0]

    with jax.set_mesh(model.mesh):
        ((loss, _), grads), logits = jax.jit(both)(
            params, jax.tree.map(jnp.asarray, batch))
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            [np.asarray(g) for g in jax.tree.leaves(grads)],
            np.asarray(logits))


def _cfg(label):
    _, arch, over = next(a for a in ARCHS if a[0] == label)
    return tconfigs.get_smoke(arch, **FSDP_SP, **over)


_RUNS: dict = {}


def _procs(pool, label, ranks):
    """The pool entry ``loss`` of the case (one run a case, shared)."""
    key = (label, ranks)
    if key not in _RUNS:
        _, arch, over = next(a for a in ARCHS if a[0] == label)
        weights, batch = _reference(label)[:2]
        _RUNS[key] = pool.call("loss", None, arch=arch, smoke=True,
                               ranks=ranks, batch=batch, weights=weights,
                               mesh=_mesh(ranks), **FSDP_SP, **over)
    return _RUNS[key]


def _stacked(label, ranks):
    """The stacked port's fsdp_sp loss, gradient leaves and forward
    logits on the reference's weights and batch (one thread, as the
    pool's processes run)."""
    weights, batch = _reference(label)[:2]
    cfg = _cfg(label)
    model = TModel(cfg, ranks, device="cpu")
    params = model.load_params(tparams.from_reference(weights, cfg, "cpu"),
                               trainable=True)
    held = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _one_thread():
        loss, _ = model.loss(params, held)
        grads = torch.autograd.grad(loss, _tree.leaves(params))
        logits, _ = model.forward(params, *_inputs(held))
    return float(loss.detach()), grads, logits.numpy()


def _close(got, want, atol, rtol, what):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=atol * max(scale, 1e-30), rtol=rtol,
                               err_msg=what)


def _held_logits(logits, ranks):
    """The whole batch's logits (B, S, V) from every process's (its
    rows and positions, process k = (i, j))."""
    D, tp = ranks
    rows = [np.concatenate(list(logits[i * tp:(i + 1) * tp]), axis=1)
            for i in range(D)]
    return np.concatenate(rows, axis=0)


# ------------------------------ the shares ------------------------------


@pytest.mark.parametrize("ranks", LAYOUTS, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("label", ["rwkv4", "llama"])
def test_shares_are_the_rule_tables_grid_slices(label, ranks):
    """Each process's share (``shard_params``) is its slice of every leaf
    as ``param_shardings`` lays it on the (data, model) grid: every
    "embed" dim over the whole grid, in the grid's row-major order, the
    rest whole; the sliced leaves' shares add up to the whole leaves,
    and ``share_nbytes`` counts each share."""
    cfg = _cfg(label)
    mesh = make_host_mesh(*ranks)
    tree = tparams.init_params(cfg, 0, "cpu")
    specs = tparams.param_shardings(cfg, mesh, trules.rules_for(cfg))
    whole = sliced = 0
    for k in range(4):
        share = tparams.shard_params(tree, cfg, mesh, k)
        pos = dict(zip(mesh.axis_names, divmod(k, ranks[1])))
        for path, d, stacked in tparams._iter_defs(cfg):
            leaf = (lambda t: t["top"][path[0]] if len(path) == 1
                    else t["blocks"][path[1]][path[2]])
            spec = specs["top"][path[0]] if len(path) == 1 \
                else specs["blocks"][path[1]][path[2]]
            want = leaf(tree)
            for dim, entry in enumerate(spec.spec):
                axes = trules.entry_axes(entry)
                assert "model" not in axes or d.axes[dim - stacked] == \
                    "embed", path
                i, n = 0, 1
                for a in axes:
                    i, n = i * mesh.shape[a] + pos[a], n * mesh.shape[a]
                size = want.shape[dim] // n
                want = want.narrow(dim, i * size, size)
            got = leaf(share)
            assert torch.equal(got, want), (k, path)
            if got.shape != leaf(tree).shape:
                sliced += got.numel()
                whole += leaf(tree).numel() if k == 0 else 0
        assert sum(tparams.share_nbytes(cfg, mesh, k).values()) == \
            sum(v.numel() * v.element_size() for v in _tree.leaves(share))
    assert sliced == whole > 0


# ------------------------- forward, loss, gradients -------------------------


@pytest.mark.parametrize("ranks", LAYOUTS, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("label", [a[0] for a in ARCHS])
def test_loss_grads_and_forward_match_reference_and_stacked(pool4, label,
                                                            ranks):
    """``Model.loss``, its gradients and ``Model.forward`` over the pool:
    the JAX package's single-device values and the stacked port's
    fsdp_sp run's; every process computes the global loss."""
    _, _, want_loss, want_grads, want_logits = _reference(label)
    res = _procs(pool4, label, ranks)
    out = res.outputs
    np.testing.assert_array_equal(out["loss"], out["loss"][0])
    np.testing.assert_allclose(float(out["loss"][0]), want_loss, atol=ATOL,
                               rtol=RTOL)
    cfg = _cfg(label)
    mesh = make_host_mesh(*ranks)
    shares = [_tree.tree_map(lambda a, k=k: a[k], out["grads"])
              for k in range(4)]
    joined = tparams.join_shares(shares, cfg, mesh)
    paths = tparams.leaf_paths(joined)
    joined = _tree.leaves(joined)
    assert len(joined) == len(want_grads)
    loss, grads, logits = _stacked(label, ranks)
    np.testing.assert_allclose(float(out["loss"][0]), loss, rtol=STEP_RTOL)
    for path, g, w, s in zip(paths, joined, want_grads, grads):
        assert tuple(g.shape) == w.shape, path
        _close(g.numpy(), w, *REF_GRAD, f"reference {path}")
        _close(g.numpy(), s.numpy(), *STACKED, f"stacked {path}")
    got = _held_logits(out["logits"], ranks)
    _close(got, want_logits, *REF_GRAD, "reference logits")
    _close(got, logits, *STACKED, "stacked logits")


@pytest.mark.parametrize("ranks", LAYOUTS, ids=lambda r: f"{r[0]}x{r[1]}")
def test_carry_is_the_planned_exscan_over_the_model_processes(pool4, ranks):
    """RWKV6's wkv carry runs its plan at p = tp over each data rank's
    "model" processes: a layer's rounds the plan's, in the loss's
    forward, its recompute, the mirrored backward and the forward (four
    runs); the processes' point-to-point messages and bytes
    ``expected_messages`` of the plan laid over the grid (the carry is
    the only point-to-point traffic)."""
    res = _procs(pool4, "rwkv4", ranks)
    cfg = _cfg("rwkv4")
    D, tp = ranks
    B_k, H = B // D, cfg.d_model // HEAD_DIM
    width = H * HEAD_DIM * HEAD_DIM
    pl = plan(tcp._carry_spec(cfg.scan_spec, None), tp,
              nbytes=tcp.carry_nbytes(B_k, width, HEAD_DIM, 4))
    runs = 4 * cfg.n_layers
    assert res.stats["rounds"] == runs * pl.rounds
    one = (torch.zeros(B_k, width), torch.zeros(B_k, width))
    msgs, nbytes = tsch.expected_messages(
        tsch.on_mesh(pl.schedule(), ("model",), _mesh(ranks)), one)
    assert res.transport["msgs"] == runs * msgs > 0
    assert res.transport["bytes"] == runs * nbytes


@pytest.mark.parametrize("label", ["llama", "pixtral"])
def test_a_shard_boundary_keeps_the_next_shards_label(label):
    """The labels are rolled over the whole row before a shard is taken:
    the last position of shard m predicts shard m+1's first token, and
    only the row's last position (and Pixtral's prefix positions) carry
    no weight."""
    cfg = _cfg(label)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             synthetic_batch(cfg, B, S, 0).items()}
    n = cfg.n_prefix if cfg.frontend == "vision" else 0
    total, tp = S + n, 4
    model = TModel(cfg, (1, 1), device="cpu")
    labels = batch["labels"].long()
    for m in range(tp):
        model._span = SeqShard(None, total, tp, m)
        got, weights = model._held_targets(batch, "cpu")
        lo, hi = model._span.lo, model._span.hi
        assert got.shape == (B, hi - lo)
        t = hi - 1 - n  # the token position of the shard's last
        if m < tp - 1:
            assert torch.equal(got[:, -1], labels[:, t + 1])
            assert bool((weights[:, -1] == 1).all())
        else:
            assert bool((weights[:, -1] == 0).all())
        prefix = max(0, min(hi, n) - lo)
        assert bool((weights[:, :prefix] == 0).all())
        assert bool((weights[:, prefix:-1] == 1).all())


# ------------------------------ training ------------------------------


def _argv(arch, ranks, steps, *extra, seq=S):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--data-mesh",
            str(ranks[0]), "--model-mesh", str(ranks[1]), "--steps",
            str(steps), "--batch", str(B), "--seq", str(seq), *extra]


@pytest.mark.parametrize("label,ranks", [("rwkv4", (2, 2)),
                                         ("llama", (1, 4))])
def test_train_over_processes_matches_the_stacked_run(pool4, label, ranks):
    """Two steps of ``train`` over the pool under fsdp_sp: each step's
    loss the stacked run's (``launch.train.run`` with the same
    overrides, rtol 1e-5), each process's collectives
    ``params.train_collectives``'."""
    _, arch, over = next(a for a in ARCHS if a[0] == label)
    over = {**FSDP_SP, **over}
    argv = _argv(arch, ranks, 2)
    got = ttrain.train_procs(pool4, argv, over=over)
    with _one_thread():
        want = ttrain.run(ttrain.parse_args(argv), quiet=True,
                          over=over).losses
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], want,
                               rtol=STEP_RTOL)
    cfg = ttrain.config_of(ttrain.parse_args(argv), over)
    mesh = make_host_mesh(*ranks)
    for k, steps in enumerate(got["collectives"]):
        want = tparams.train_collectives(cfg, mesh, k, batch=B, seq=S)
        for step in steps:
            assert {kind: {"calls": c["calls"], "bytes": c["bytes"]}
                    for kind, c in step.items()} == want, (k, step)


@pytest.mark.parametrize("ranks", LAYOUTS, ids=lambda r: f"{r[0]}x{r[1]}")
def test_autotune_over_processes_installs_alike(pool4, ranks):
    """``train --autotune`` over the pool (RWKV6 under fsdp_sp, whose
    carry the installed profile reprices): every process records the
    slowest process's probe seconds, so each refits and installs the
    same profile at the same steps.  The probe runs over the "data"
    processes at (2, 2) and, where one data process leaves p = 2 no
    group (1, 4), stacked on each process's device.  The gate is opened
    (a refit every probe, no drift or residual bar) so that it
    installs."""
    argv = _argv(RWKV, ranks, 4, "--autotune", "--autotune-every", "1")
    gate = DriftGate(drift=0.0, max_residual=float("inf"), min_samples=2)
    got = ttrain.train_procs(pool4, argv, over={**FSDP_SP, **RWKV4},
                             tuner_kw={"refit_every": 1, "gate": gate})
    tuned = got["autotune"]
    assert all(t == tuned[0] for t in tuned[1:]), tuned
    assert [s["installed"] for s in tuned[0]] == [0.0, 1.0, 1.0, 1.0]
    assert all(s["probe_s"] > 0 for s in tuned[0])
    assert len({s["profile"] for s in tuned[0]}) == 4
    assert len(got["metrics"]) == 4


# ---------------------------- the dry run ----------------------------


def test_train_collectives_against_the_dry_run():
    """A process's collectives in a fsdp_sp training step
    (``train_collectives``) against the dry run's price for a rank
    (``collectives_of(train=True)``), the differences named: the
    weights go as one bucket a layer over the grid (and one for the
    embedding, one for the head) where the dry run gathers and
    reduce-scatters each leaf; attention's k and v go as one gather a
    layer (forward and recompute) and one reduce-scatter back, where
    the dry run prices the wk and wv sites apart; the CE's sums, the
    gradient sync of the leaves whole over the grid and the norm, which
    the dry run does not price; RWKV6's token shifts, which it leaves to
    the compiler; and the carry's rounds, its collective-permutes, which
    the processes count as the scan's rounds."""
    shape = tsteps.ShapeSpec("train_b4_s16", "train", S, B)
    for label, ranks in (("llama", (2, 2)), ("rwkv4", (1, 4))):
        cfg = _cfg(label)
        mesh = make_host_mesh(*ranks)
        coll = tsteps.lower_cell(cfg, shape, mesh).compile().collectives()
        got = tparams.train_collectives(cfg, mesh, 0, batch=B, seq=S)
        cuts = tparams.data_cuts(cfg, mesh, 0)
        stacked = len([p for p in cuts if len(p) == 3])
        top = len([p for p in cuts if len(p) == 1])
        r, layers = cfg.n_repeats, len(cfg.pattern())
        attn = r * sum(s.kind == "attn" for s in cfg.pattern())
        rwkv = r * sum(s.kind == "rwkv" for s in cfg.pattern())
        # gathers: one a leaf (twice for a stacked one under remat) and
        # wk's and wv's forward and recompute; against a bucket a layer
        assert coll.op_counts["all-gather"] == 2 * stacked + top + 4 * attn
        assert got["fsdp_gather"]["calls"] == 2 * r * layers + top
        assert got["seq_kv"]["calls"] == 2 * attn
        assert coll.op_counts["reduce-scatter"] == stacked + top + 2 * attn
        assert got["fsdp_scatter"]["calls"] == r * layers + top
        assert got["seq_kv_scatter"]["calls"] == attn
        assert got["seq_shift"]["calls"] == 4 * rwkv
        assert got["seq_shift_scatter"]["calls"] == 2 * rwkv
        assert (got["all_reduce"]["calls"], got["grad_sync"]["calls"],
                got["grad_norm"]["calls"]) == (1, 1, 1)
        assert "all-reduce" not in coll.op_counts
        for kind in ("all_gather", "all_to_all", "reduce_scatter",
                     "kv_sync"):
            assert got[kind]["calls"] == 0, kind
        if rwkv:
            B_k, width = B // ranks[0], cfg.d_model * HEAD_DIM
            pl = plan(tcp._carry_spec(cfg.scan_spec, None), ranks[1],
                      nbytes=tcp.carry_nbytes(B_k, width, HEAD_DIM, 4))
            assert coll.op_counts["collective-permute"] == \
                3 * rwkv * pl.rounds
        else:
            assert "collective-permute" not in coll.op_counts


# ------------------------------ refusals ------------------------------


def test_refusals_before_any_message(pool4):
    """Every process refuses before a message, and the pool stays up:
    the MoE configs under fsdp_sp (the reference's decision: "experts"
    and "embed" both over "model"), a call with a cache under fsdp_sp
    (the cache's sequence over "model", ROADMAP Queue 1 item 2.4) and a
    sequence the model processes do not divide."""
    ranks = (1, 4)
    with pytest.raises(RuntimeError, match="ValueError: .*'model'"):
        ttrain.train_procs(pool4, _argv(QWEN, ranks, 1), over=FSDP_SP)
    with pytest.raises(RuntimeError, match="NotImplementedError: a call "
                                           "with a cache under fsdp_sp.*"
                                           "Queue 1 item 2.4"):
        pool4.call("serve", None, arch=RWKV, smoke=True, batch=2,
                   prompt_len=8, gen=1, ranks=ranks, mesh=_mesh(ranks),
                   **FSDP_SP, **RWKV4)
    with pytest.raises(RuntimeError, match="ValueError: fsdp_sp over "
                                           "processes splits the sequence"
                                           ".*18 positions"):
        ttrain.train_procs(pool4, _argv(LLAMA, ranks, 1, seq=18),
                           over=FSDP_SP)
    got = ttrain.train_procs(pool4, _argv(LLAMA, ranks, 1), over=FSDP_SP)
    assert len(got["metrics"]) == 1
