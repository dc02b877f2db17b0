"""Model assembly: the layer stack, forward, the loss and the serving
step, from the JAX package's ``models/model.py``.

``Model`` is an ``nn.Module`` that holds its parameters under the JAX
tree's names and shapes (block leaves stacked on a leading
``n_repeats`` axis), so weights carried across from the reference with
``params.from_reference`` are a copy.  Its methods take the parameter
tree as the reference's do; ``None`` means the module's own.  Serving
holds the parameters frozen; ``load_params(tree, trainable=True)``
holds them for training.  The stack is a loop over the repeats; under
autograd each repeat is checkpointed when ``cfg.remat``: under policy
"nothing" (the reference's default) only the repeat's input is kept and
its activations are recomputed in the backward; under "dots" every
matrix product's output is kept as well (the reference's
``dots_saveable``).  ``forward`` and
``serve_step`` run without autograd; ``loss`` runs with it.  Caches are
updated in place: ``serve_step`` writes the new keys, values and
states into the cache it is given and returns it.

The mesh the reference takes becomes ``ranks``: the (data, model)
shape of the rank grid the model stands for (or a
``launch.mesh.HostMesh``).  On one card the ranks are leading axes of
its tensors; the MoE layers group their tokens by it, and run the
dispatch offsets and totals through ``scan_with_total`` on the stacked
executor.  With an ``SPMDExecutor`` over the (data, model) grid, one
rank a process, process k is mesh rank (i, j) = divmod(k, tp): it holds
its rows of the batch (``moe.held_rows``; the same rows on the model
processes of its data shard) and runs the dense layers on them, holds
only its e_pad/tp experts (``params.shard_params``), and its MoE layers
exchange tokens with the other processes (``moe.moe_ffn``).  Nothing
else crosses processes: serving under the "tp" strategy needs nothing
else, and what would (the fsdp_sp forward's context-parallel scans,
training) raises ``NotImplementedError``.

``forward``, ``loss`` and ``serve_step`` run under the mesh's rule
table (``sharding.ctx.use_mesh_rules``), and the layers pin their
activations' logical axes where the reference does: on one card that
changes nothing, and the dry run (``launch/dryrun.py``) reads it.
``abstract_params``, ``param_shardings``, ``abstract_cache`` and
``cache_logical_axes`` give the cell's inputs and their shardings
without storage.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import device as device_lib
from repro_torch.core.schedule import SPMDExecutor, StackedExecutor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import params as PD
from repro_torch.models.attention import attention_block
from repro_torch.models.common import rmsnorm, softcap, swiglu
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import init_mamba_cache, mamba_block
from repro_torch.models.moe import (QUEUE_ITEM, check_layout, expert_range,
                                   held_rows, moe_block)
from repro_torch.models.rwkv import init_rwkv_cache, rwkv_block
from repro_torch.sharding import ctx as sharding_ctx
from repro_torch.sharding import rules as rules_lib
from repro_torch.sharding.ctx import constrain, use_mesh_rules


def _param(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


# The matrix products of the port's layers: every ``@`` and einsum
# reaches one of these.
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
        torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """Policy "dots": keep every matrix product's output, recompute the
    rest (the reference's ``jax.checkpoint_policies.dots_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_saveable)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, ranks=(1, 1), device=None,
                 executor=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = ranks if hasattr(ranks, "axis_names") \
            else make_host_mesh(*ranks)
        self.dev = device_lib.resolve(device)
        self.procs = isinstance(executor, SPMDExecutor)
        if self.procs:
            check_layout(cfg, self.mesh, executor)
            # every process makes the axes' groups here, in one order,
            # before any message
            for axis in self.mesh.axis_names:
                executor.axis_group(axis)
        self.executor = executor if executor is not None \
            else StackedExecutor(self.dev)
        self.top = nn.ParameterDict()
        self.blocks = nn.ModuleList()
        self._batch = None  # the global batch of the call in progress
        self._blocks = 1  # its attention's blocks of rows (_call)

    # ------------------------- params -------------------------

    def init_params(self, generator: torch.Generator | int = 0,
                    trainable: bool = False):
        """Materialise random weights (``params.init_params``) on the
        model's device and hold them; returns the tree.  Over processes,
        this process's experts only: the stacked model's weights from
        the same generator, sliced."""
        experts = expert_range(self.cfg, self.mesh, self.executor.rank) \
            if self.procs else None
        return self.load_params(PD.init_params(self.cfg, generator, self.dev,
                                               experts=experts),
                                trainable=trainable)

    def rows(self, batch: int) -> slice:
        """The rows of a global batch this model holds: all of them on
        one card, this process's over processes (``moe.held_rows``)."""
        if not self.procs:
            return slice(0, batch)
        return held_rows(batch, self.mesh, self.executor.rank)

    @contextlib.contextmanager
    def _call(self, rows: int, batch: int | None):
        """A call on ``rows`` rows of a global ``batch``: the MoE layers
        read it (by default the rows are all of it on one card, data
        shard i over processes).  On one card the attention takes the
        rows a data shard at a time, as the processes that hold the
        shards do (``attention_core``'s ``batch_blocks``), so the two
        runs' products have one shape."""
        if batch is None:
            batch = rows * (self.mesh.shape["data"] if self.procs else 1)
        got = self.rows(batch)
        if got.stop - got.start != rows:
            raise ValueError(f"{rows} rows given; this model holds "
                             f"{got.stop - got.start} of a batch of "
                             f"{batch}")
        n_data = 1 if self.procs else self.mesh.shape.get("data", 1)
        self._batch = batch
        self._blocks = n_data if batch % n_data == 0 else 1
        try:
            with self._rules():
                yield
        finally:
            self._batch, self._blocks = None, 1

    def load_params(self, tree, trainable: bool = False):
        """Hold ``tree`` (``{"top": ..., "blocks": (...)}`` on the
        model's device, e.g. from ``params.from_reference``) as the
        module's parameters, without copying; returns the tree.  They
        are frozen for serving, or leaves that take gradients where
        ``trainable``."""
        self.top = nn.ParameterDict({k: _param(v, trainable)
                                     for k, v in tree["top"].items()})
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: _param(v, trainable) for k, v in b.items()})
            for b in tree["blocks"])
        return self.params

    def abstract_params(self):
        """The parameter tree as meta tensors (``params.abstract_params``)."""
        return PD.abstract_params(self.cfg)

    def param_shardings(self, rules):
        return PD.param_shardings(self.cfg, self.mesh, rules)

    def _rules(self):
        return use_mesh_rules(self.mesh, rules_lib.rules_for(self.cfg))

    @property
    def params(self):
        return {"top": dict(self.top),
                "blocks": tuple(dict(b) for b in self.blocks)}

    # ------------------------- layers -------------------------

    def _ffn(self, spec, p, x):
        """Post-attention FFN half of a block. Returns (x, aux)."""
        cfg = self.cfg
        if spec.use_moe:
            return moe_block(cfg, p, x, self.mesh, executor=self.executor,
                             batch=self._batch if self.procs else None)
        xn = rmsnorm(x, p["norm2"], cfg.norm_eps)
        y = swiglu(xn, p["w_gate"], p["w_up"], p["w_down"])
        return x + y, torch.zeros(2, dtype=torch.float32, device=x.device)

    def _layer(self, spec, p, x, positions, cache=None, cache_len=None):
        cfg = self.cfg
        if spec.kind == "attn":
            x, new_cache = attention_block(
                cfg, p, x, positions, window=spec.sliding_window,
                cache=cache, cache_len=cache_len, batch_blocks=self._blocks)
            x, aux = self._ffn(spec, p, x)
        elif spec.kind == "mamba":
            x, new_cache = mamba_block(cfg, p, x, cache=cache)
            x, aux = self._ffn(spec, p, x)
        elif spec.kind == "rwkv":
            x, new_cache = rwkv_block(cfg, p, x, cache=cache, mesh=self.mesh)
            aux = torch.zeros(2, dtype=torch.float32, device=x.device)
        else:
            raise ValueError(spec.kind)
        return x, aux, new_cache

    @staticmethod
    def _at(tree: dict, r: int) -> dict:
        """Repeat r's slice of a stacked dict (views)."""
        return {k: v[r] for k, v in tree.items()}

    # ------------------------- forward -------------------------

    def _embed(self, p_top, tokens, prefix_embeds=None):
        """tokens: (B, S_tok) int or None; prefix_embeds: (B, n, d) —
        vlm patch embeddings (prepended) or audio frame embeddings (the
        whole input).  Frontends are stubs, as in the reference."""
        cfg = self.cfg
        if tokens is not None:
            x = p_top["tok_embed"][tokens.long()]
            if cfg.frontend == "vision" and prefix_embeds is not None:
                x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        else:
            x = prefix_embeds  # audio: frame embeddings are the input
        return x

    def _repeat(self, layers, x, aux, positions):
        """One repeat of the stack: its pattern's layers (``layers``, one
        dict of that repeat's slices per position), each layer's aux
        added to the running ``aux`` in turn (the reference's carry).
        Returns (x, aux)."""
        for spec, p in zip(self.cfg.pattern(), layers):
            x, aux_j, _ = self._layer(spec, p, x, positions)
            aux = aux + aux_j
        return x, aux

    def _stack(self, params, x, positions):
        """Run the layer stack. Returns (x, aux_sum).  Under autograd
        with ``cfg.remat`` each repeat is checkpointed: policy "dots"
        keeps the matrix products' outputs, any other policy nothing (as
        the reference reads ``cfg.remat_policy``)."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        kw = {"context_fn": _DOTS_CONTEXT} \
            if cfg.remat_policy == "dots" else {}
        aux = torch.zeros(2, dtype=torch.float32, device=x.device)
        # one unbind per stacked leaf: its backward stacks the repeats'
        # gradients once, where a slice per repeat would add a zero-padded
        # full-size gradient per repeat
        slices = tuple({k: v.unbind(0) for k, v in b.items()}
                       for b in params["blocks"])
        # the recompute runs in the backward, outside this call's rule
        # context: it enters the same one
        rules_ctx = sharding_ctx.current()

        def repeat(*args):
            if rules_ctx is None:
                return self._repeat(*args)
            with use_mesh_rules(*rules_ctx):
                return self._repeat(*args)

        for r in range(cfg.n_repeats):
            layers = tuple({k: v[r] for k, v in b.items()} for b in slices)
            if remat:
                x, aux = checkpoint(repeat, layers, x, aux, positions,
                                    use_reentrant=False, **kw)
            else:
                x, aux = self._repeat(layers, x, aux, positions)
        return x, aux

    def logits_fn(self, params, x):
        cfg = self.cfg
        x = rmsnorm(x, params["top"]["final_norm"], cfg.norm_eps)
        w = params["top"]["tok_embed"].T if cfg.tie_embeddings \
            else params["top"]["lm_head"]
        logits = softcap((x @ w).float(), cfg.logit_softcap)
        vp = PD.vocab_padded(cfg)
        if vp != cfg.vocab:
            vmask = torch.arange(vp, device=x.device) < cfg.vocab
            logits = torch.where(vmask, logits, torch.full(
                (), -1e30, dtype=logits.dtype, device=x.device))
        return logits

    def _forward(self, params, tokens, prefix_embeds=None, positions=None):
        params = self.params if params is None else params
        x = self._embed(params["top"], tokens, prefix_embeds)
        x = constrain(x, "batch", "seq", "embed_act", site="embed")
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        x, aux = self._stack(params, x, positions)
        return self.logits_fn(params, x), aux

    def check_forward(self) -> None:
        """Raise where ``forward`` cannot run here: over processes under
        fsdp_sp, whose forward without a cache runs the context-parallel
        scans inside the model."""
        if self.procs and self.cfg.sharding_strategy == "fsdp_sp":
            raise NotImplementedError(
                f"the fsdp_sp forward without a cache runs context-parallel "
                f"scans inside the model, which over processes is "
                f"{QUEUE_ITEM}")

    @torch.no_grad()
    def forward(self, params=None, tokens=None, prefix_embeds=None,
                positions=None, batch: int | None = None):
        """Full-sequence forward (prefill without a cache), without
        autograd. Returns (logits fp32 (B, S, vocab_padded), aux).  Over
        processes the inputs are this process's rows of a global
        ``batch`` (``rows``)."""
        self.check_forward()
        x = tokens if tokens is not None else prefix_embeds
        with self._call(x.shape[0], batch):
            return self._forward(params, tokens, prefix_embeds, positions)

    def loss(self, params, batch):
        """batch: {"tokens" or "embeds", "labels", optional "prefix"},
        tensors on the model's device.  Next-token CE for causal LMs;
        per-position CE for encoders.  Returns (loss, metrics), with
        autograd (the reference's ``Model.loss``, term for term)."""
        if self.procs:
            raise NotImplementedError(f"training over processes is "
                                      f"{QUEUE_ITEM}")
        cfg = self.cfg
        tokens = batch.get("tokens")
        prefix = batch.get("embeds") if cfg.frontend == "audio" else \
            batch.get("prefix")
        with self._rules():
            logits, aux = self._forward(params, tokens, prefix)
            return self._loss_inner(logits, aux, batch)

    def _loss_inner(self, logits, aux, batch):
        cfg = self.cfg
        n_moe = sum(1 for s in cfg.pattern() if s.use_moe) * cfg.n_repeats
        aux = aux / max(n_moe, 1)  # per-MoE-layer means
        logits = constrain(logits, "batch", "seq", "vocab", site="logits")
        labels = batch["labels"].long()
        B, S_l = labels.shape
        n_prefix = logits.shape[1] - S_l
        dev = logits.device
        if cfg.causal and not cfg.encoder_only:
            # predict labels[t+1] at position t; last position masked
            labels = torch.roll(labels, -1, dims=1)
            weights = torch.cat(
                [torch.ones((B, S_l - 1), dtype=torch.float32, device=dev),
                 torch.zeros((B, 1), dtype=torch.float32, device=dev)], dim=1)
        else:
            weights = torch.ones((B, S_l), dtype=torch.float32, device=dev)
        if n_prefix:  # vlm: prefix positions carry no labels
            labels = torch.cat([torch.zeros((B, n_prefix), dtype=labels.dtype,
                                            device=dev), labels], dim=1)
            weights = torch.cat([torch.zeros((B, n_prefix),
                                             dtype=torch.float32, device=dev),
                                 weights], dim=1)
        logits32 = logits.float()
        zmax = torch.amax(logits32, dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(logits32 - zmax), dim=-1)) + \
            zmax[..., 0]
        # the reference's sum over a one-hot: one nonzero term, exact
        label_logit = torch.gather(logits32, -1, labels[..., None])[..., 0]
        nll = (lse - label_logit) * weights
        ce = torch.sum(nll) / torch.clamp(torch.sum(weights), min=1.0)
        lb_loss = aux[0] * 0.01  # load-balance coefficient
        metrics = {"ce": ce, "load_balance": aux[0], "dropped": aux[1]}
        return ce + lb_loss, metrics

    # ------------------------- decode -------------------------

    def init_cache(self, batch: int, max_len: int, kv_dup: int = 1,
                   device=None):
        """Stacked-by-repeat caches, one entry per pattern position; the
        attention caches hold ``n_kv_heads · kv_dup`` heads (duplicated
        to the TP degree, ``launch.steps.kv_dup``)."""
        cfg = self.cfg
        dtype = PD.torch_dtype(cfg)
        r = cfg.n_repeats
        dev = self.dev if device is None else torch.device(device)

        def stacked(c):
            return {k: v.expand(r, *v.shape).contiguous()
                    for k, v in c.items()}

        caches = []
        for spec in cfg.pattern():
            if spec.kind == "attn":
                shape = (r, batch, max_len, cfg.n_kv_heads * kv_dup,
                         cfg.head_dim_)
                caches.append({
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)})
            elif spec.kind == "mamba":
                caches.append(stacked(init_mamba_cache(cfg, batch, dtype,
                                                       dev)))
            else:
                caches.append(stacked(init_rwkv_cache(cfg, batch, dtype,
                                                      dev)))
        return tuple(caches)

    def abstract_cache(self, batch: int, max_len: int, kv_dup: int = 1):
        """``init_cache``'s tree as meta tensors."""
        return self.init_cache(batch, max_len, kv_dup, device="meta")

    def cache_logical_axes(self, seq_sharded: bool = False,
                           kv_shardable: bool = True):
        """Logical-axis tree matching init_cache's structure.

        seq_sharded: long-context mode — cache seq over the data axis.
        kv_shardable: False when no kv duplication makes the heads dim
        divisible by TP (then seq shards over "model" instead)."""
        if seq_sharded:
            seq_ax, b_ax = "cache_seq_shard", None
        elif not kv_shardable:
            seq_ax, b_ax = "cache_seq_tp", "cache_batch"
        else:
            seq_ax, b_ax = "cache_seq", "cache_batch"
        kv_ax = "cache_kv" if kv_shardable else None
        out = []
        for spec in self.cfg.pattern():
            if spec.kind == "attn":
                ax = ("layers", b_ax, seq_ax, kv_ax, None)
                out.append({"k": ax, "v": ax})
            elif spec.kind == "mamba":
                out.append({
                    "conv": ("layers", b_ax, None, "d_inner"),
                    "h": ("layers", b_ax, "d_inner", None),
                })
            else:
                out.append({
                    "shift": ("layers", b_ax, None, None),
                    "cm_shift": ("layers", b_ax, None, None),
                    "state": ("layers", b_ax, "heads", None, None),
                })
        return tuple(out)

    def decode_step(self, params, cache, tokens, cache_len: int,
                    batch: int | None = None):
        """One-token decode.  tokens: (B, 1) int; cache_len: int.

        Returns (logits (B, 1, V), cache)."""
        return self.serve_step(params, cache, tokens, cache_len,
                               batch=batch)

    @torch.no_grad()
    def serve_step(self, params, cache, tokens, cache_len: int,
                   prefix_embeds=None, last_only: bool = False,
                   batch: int | None = None):
        """Serving step: decode (S=1) or prefill (S>1) into the cache.

        tokens: (B, S) int; cache_len: int (valid cache length before
        this call).  Returns (logits, cache), the cache updated in
        place; with ``last_only`` the logits cover only the final
        position (prefill avoids materialising (B, S, vocab)).  Over
        processes tokens and cache are this process's rows of a global
        ``batch`` (``rows``)."""
        with self._call(tokens.shape[0], batch):
            return self._serve_step_inner(params, cache, tokens, cache_len,
                                          prefix_embeds, last_only)

    def _serve_step_inner(self, params, cache, tokens, cache_len,
                          prefix_embeds, last_only):
        params = self.params if params is None else params
        cfg = self.cfg
        x = self._embed(params["top"], tokens, prefix_embeds)
        x = constrain(x, "batch", None, None, site="embed")
        B, S, _ = x.shape
        positions = cache_len + torch.arange(
            S, dtype=torch.int32, device=x.device).expand(B, S)
        for r in range(cfg.n_repeats):
            for j, spec in enumerate(cfg.pattern()):
                x, _, _ = self._layer(
                    spec, self._at(params["blocks"][j], r), x, positions,
                    cache=self._at(cache[j], r), cache_len=cache_len)
        if last_only:
            x = x[:, -1:]
        return self.logits_fn(params, x), cache
