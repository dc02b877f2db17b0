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
processes of its data shard), only its e_pad/tp experts, and, where the
config's rule table splits them over "model" (``params.plan_split``, the
"tp" table's placement), model rank j's share of the dense layers
(``params.shard_params``): its q heads and the kv heads they read (one
kv head that tp/n_kv processes share where n_kv < tp) and wo's matching
rows, its columns of the dense FFN's and the shared experts' gate and
up and rows of their down, its vocab_padded/tp rows of the embedding
and columns of the head, its RWKV6 wkv heads (r, k, v, g and decay
columns, wo's rows, its part of the state) and channel-mix columns
(cm_wk's, cm_wv's rows), and its Mamba d_inner channels (x_in's and
z's columns of in_proj, conv, dt_proj's columns, x_proj's, A's and
out_proj's rows, its part of the conv and SSM caches).  Each row-split
product (attention's and RWKV6's wo, cm_wv, Mamba's x_proj and
out_proj, w_down, shared_down) is a partial, summed by one
``SPMDExecutor.all_reduce`` over "model"; the embedding looks up the
ids in its rows, zeros elsewhere, and all-reduces (one nonzero term:
exact); the logits are this process's vocabulary columns, all-gathered
over "model" so every process sees the whole row.  Its MoE layers
exchange tokens with the other processes (``moe.moe_ffn``).  The norms,
the router, the token shifts and RWKV6's ``cm_wr`` stay whole over
"model".

Over "data" the weights are split as well as the batch (FSDP, as the
"tp" table puts "embed" on the data axes): process (i, j) holds data
rank i's d/n_data slice of the "embed" dim of every leaf that has one
(``params.data_cuts``: the projections into and out of d_model, the
router, the experts, the embedding, the head, RWKV6's ``cm_wr``), and
each layer gathers its slices over "data" where it is used, in one
all-gather a layer (``shards.gather_data``), dropping the gathered
leaves when the layer is done: the embedding at the lookup, the head at
the logits, each repeat's position before its layer, in the forward,
the loss and the serving step.  Where a call's MoE grouping is
weight-stationary (decode: ``moe.moe_groups``) the routed experts stay
out of the gather and the expert FFN multiplies d-slices, the
reference's ``_swiglu_experts_ws``.  A gather is exact, so the layers
compute on the whole leaves' bits.  A layout the split cannot make
whole raises before any message.

Under the decode_ws strategy ("embed_act" over "data", "batch" whole) the
weights are the same FSDP shares and never move; the activations carry
d over "data" instead (``models.shards.ProcessSlice``): process (i, j)
holds every row of the batch (``rows``) as its d/n_data channels i, the
layers keep x as (B, S, d/n_data) between them, each product from d is
a partial summed over "data" (one all-reduce a group of products that
read one input), each norm's sums of squares likewise, each product into
d writes the slice, and the head's partial is summed over "data" before
the vocabulary's all-gather over "model", so every process holds whole
logit rows.  Each mixer's core (attention's, the wkv scan, Mamba's conv
and scan) runs on the rows its cache holds, data shard i's
(``cache_rows``: "cache_batch" over "data", every row where n_data does
not divide B), and comes back to every row in one all-gather; RWKV6's
token-shift caches hold every row's slice, as the activations do.  A
weight-stationary MoE call dispatches the tokens' d-slices; another
(prefill past B·S·k = 4096) joins them over "data" and gathers its
experts, as the reference does.  On one card a model loaded for serving
at n_data > 1 computes the same slices, in the same order
(``StackedSlices``), so its tokens and logits are the processes'.
Training under decode_ws over processes raises before any message
(``check_forward``).

Under the fsdp_sp strategy ("seq" over "model", "embed" over the whole
grid, nothing else split) the "model" processes split the sequence:
model rank m computes positions [m·S/tp, (m+1)·S/tp) of its data
shard's rows (``_split_seq``: the caller gives whole rows, the model
keeps its positions after the embedding, the labels rolled over the
whole row first), each leaf's "embed" slice is gathered over every
process, attention gathers every shard's k and v over "model", RWKV6's
token shifts read the previous shard's last row and its wkv carry is
the exclusive scan over the "model" processes (``shards.SeqShard``).
Its MoE configs raise the reference's ``ValueError`` here, and a call
with a cache ``NotImplementedError`` (``check_forward``).

Over processes ``loss`` trains: each process's loss is the global one
over the global batch, and autograd gives each process the gradient of
its share (``models.shards``: the tensor-parallel enter and leave over
"model", each gathered bucket reduce-scattered over "data";
``moe.moe_ffn``'s collectives each with its transpose).  The
checkpointed repeats recompute their forward in the backward,
collectives included (the second weight gather of each layer), in
lockstep on every process.  The leaves a process holds whole over
"model" are computed alike by every model process and get the same
gradient there; those whole over "data" get each data process's part,
which the train step all-reduces (``launch.steps.make_train_step``).

On one card, a model whose mesh has tp > 1 and whose tree is loaded
for serving holds and computes all tp shares (``load_params``,
``models.shards.StackedShards``), so its bits are the processes'.  The
layers loop over the shares of ``models.shards``; a model or a layer
the split does not cover has one, the leaves whole.  One card holds
every data rank, so its leaves are whole over "data" and nothing is
gathered; its weight-stationary expert FFN multiplies the same d-slices
and sums them in the same order as the processes (``moe.moe_ffn``).

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
from repro_torch.models.common import rmsnorm, softcap
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import init_mamba_cache, mamba_block
from repro_torch.models.moe import (QUEUE_ITEM, check_layout, held_rows,
                                   moe_block, moe_groups)
from repro_torch.models.rwkv import HEAD_DIM, init_rwkv_cache, rwkv_block
from repro_torch.models.shards import (WHOLE, WHOLE_D, DSlices,
                                       ProcessShards, ProcessSlice, SeqShard,
                                       Shards, StackedShards, StackedSlices,
                                       gather_data)
from repro_torch.sharding import ctx as sharding_ctx
from repro_torch.sharding import rules as rules_lib
from repro_torch.sharding.ctx import constrain, use_mesh_rules


def _param(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


# each layer cache leaf's dims after its batch dim (a split cache holds the
# shares' axis before it): attention's (S, heads, hd), Mamba's conv (K −
# 1, di) and h (di, ds), RWKV6's shifts (1, d) and state (H, hd, hd)
_CACHE_TRAIL = {"k": 3, "v": 3, "conv": 2, "h": 2, "shift": 2,
                "cm_shift": 2, "state": 3}


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
        # the leaves this process holds a data slice of (FSDP), by their
        # cut dim: the top's, and each pattern position's; the layout's
        # refusals (fsdp_sp's MoE: "experts" and "embed" both over
        # "model") raise here, before any message
        cuts = {}
        if self.procs:
            check_layout(cfg, self.mesh, executor)
            cuts = PD.data_cuts(cfg, self.mesh, executor.rank)
            # every process makes the axes' groups here, in one order,
            # before any message
            for axis in self.mesh.axis_names:
                executor.axis_group(axis)
        self.executor = executor if executor is not None \
            else StackedExecutor(self.dev)
        # the group the FSDP slices gather over, and whether the sequence
        # is split over the "model" processes (fsdp_sp)
        self._fsdp_axis = PD.fsdp_axis(cfg, self.mesh) if self.procs \
            else "data"
        self._seq = self.procs and PD.seq_split(cfg, self.mesh)
        # None where the processes refuse the layout (check_layout has
        # raised over processes): one card then runs the layers whole
        self.split = PD.plan_split(cfg, self.mesh, refuse=False)
        split = self.split is not None and self.split.dense
        # the shares this program computes; on one card set by
        # load_params, which cuts the tree
        self.shards: Shards = ProcessShards(
            executor, executor.rank % self.split.tp) \
            if self.procs and split else WHOLE
        # decode_ws's d over "data": the activations' slices (one, whole
        # d, elsewhere); on one card set by load_params
        self._dws = PD.ws_slices(cfg, self.mesh) > 1
        self.dsl: DSlices = ProcessSlice(
            executor, executor.rank // self.mesh.shape["model"],
            self.mesh.shape["data"]) if self.procs and self._dws \
            else WHOLE_D
        self._data_top = {p[0]: c.dim for p, c in cuts.items()
                          if len(p) == 1}
        self._data_blocks = tuple(
            {p[2]: c.dim for p, c in cuts.items()
             if len(p) == 3 and p[1] == j}
            for j in range(len(cfg.pattern())))
        self._ws = False  # the call's MoE grouping is weight-stationary
        self.top = nn.ParameterDict()
        self.blocks = nn.ModuleList()
        self._batch = None  # the global batch of the call in progress
        self._blocks = 1  # its batched products' blocks of rows (_call)
        self._span = None  # its SeqShard where the sequence is split

    # ------------------------- params -------------------------

    def init_params(self, generator: torch.Generator | int = 0,
                    trainable: bool = False):
        """Materialise random weights (``params.init_params``) on the
        model's device and hold them; returns the tree.  Over processes,
        this process's share only (``params.shard_params``): the stacked
        model's weights from the same generator, sliced."""
        share = (self.mesh, self.executor.rank) if self.procs else None
        return self.load_params(PD.init_params(self.cfg, generator, self.dev,
                                               share=share),
                                trainable=trainable)

    def rows(self, batch: int) -> slice:
        """The rows of a global batch this model holds: all of them on
        one card, this process's over processes (``moe.held_rows``)."""
        if not self.procs or self._dws:
            return slice(0, batch)
        return held_rows(batch, self.mesh, self.executor.rank)

    def cache_rows(self, batch: int) -> slice:
        """The rows of a global batch whose caches this model holds:
        its rows (``rows``), or under decode_ws over processes data
        shard i's (``moe.held_rows``: the reference's "cache_batch" over
        "data"), whose cores it runs."""
        if self.procs and self._dws:
            return held_rows(batch, self.mesh, self.executor.rank)
        return self.rows(batch)

    @contextlib.contextmanager
    def _call(self, rows: int, batch: int | None):
        """A call on ``rows`` rows of a global ``batch``: the MoE layers
        read it (by default the rows are all of it on one card, data
        shard i over processes).  On one card the layers but the MoE
        FFN (``_rows``) and the logits take the rows a data shard at a
        time, as the processes that hold the shards do, so the two runs'
        products have one shape."""
        if batch is None:
            batch = rows * (self.mesh.shape["data"] if self.procs
                            and not self._dws else 1)
        got = self.rows(batch)
        if got.stop - got.start != rows:
            raise ValueError(f"{rows} rows given; this model holds "
                             f"{got.stop - got.start} of a batch of "
                             f"{batch}")
        n_data = 1 if self.procs or self.dsl.n > 1 \
            else self.mesh.shape.get("data", 1)
        self._batch = batch
        self._blocks = n_data if batch % n_data == 0 else 1
        try:
            with self._rules():
                yield
        finally:
            self._batch, self._blocks, self._ws = None, 1, False
            self._span = None

    def load_params(self, tree, trainable: bool = False):
        """Hold ``tree`` (``{"top": ..., "blocks": (...)}`` on the
        model's device, e.g. from ``params.from_reference``; over
        processes the process's share, ``params.shard_params``) as the
        module's parameters, uncopied but for the cut below; returns the
        tree held, which the calls take.  They are frozen for serving,
        or leaves that take gradients where ``trainable``.

        On one card at tp > 1, where ``plan_split`` splits the dense
        layers, a tree loaded for serving is held as all tp shares
        (``params.stack_parts``: each split leaf's parts stacked, copied
        once) and each split layer runs share by share
        (``StackedShards``), as the processes hold and run them.  The
        tree is held whole, and the layers run whole, in two cases:
        loaded ``trainable`` (the stacked training run, which the
        processes are held to within rounding, not bit for bit: the tree
        stays the checkpoint's, the reference's layout), and on the meta
        device (the dry run traces the
        reference's program, whose constraints and FLOPs are read on the
        leaves' logical shapes; traced split, the dry-run CLI's four
        cells also took 89.5 s against 10.0 s whole: PERF.md §6).
        Under decode_ws at n_data > 1 a tree loaded for serving also runs
        d slice by slice (``StackedSlices``), as the data processes hold
        it."""
        if not self.procs:
            serving = not trainable and self.dev.type != "meta"
            cut = self.split is not None and self.split.dense and serving
            self.shards = StackedShards(self.split.tp) if cut else WHOLE
            self.dsl = StackedSlices(self.mesh.shape["data"]) \
                if self._dws and serving else WHOLE_D
            if cut:
                tree = PD.stack_parts(tree, self.cfg, self.mesh)
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

    def _shards(self, part: str) -> Shards:
        """The shares of ``part``'s leaves (a ``params.Split`` flag:
        "heads", "mlp", "vocab", "wkv", "cmix", "d_inner") this program
        computes: ``WHOLE`` where the split does not cover it."""
        if self.split is None or not getattr(self.split, part):
            return WHOLE
        return self.shards

    def _gathered(self, j: int, p: dict) -> dict:
        """Pattern position j's leaves ``p`` (one repeat's) as the layer
        reads them: over processes, the slices this process holds over
        "data" gathered in one all-gather (``shards.gather_data``), the
        routed experts left sliced where the call's MoE grouping is
        weight-stationary (``moe.moe_ffn`` multiplies by its slice);
        on one card ``p`` itself."""
        dims = self._data_blocks[j]
        if self._dws:  # weights never move, but for a gathered MoE call
            dims = {} if self._ws else \
                {k: v for k, v in dims.items() if PD.is_expert_leaf(k)}
        elif self._ws:
            dims = {k: v for k, v in dims.items() if not PD.is_expert_leaf(k)}
        return gather_data(self.executor, p, dims, self._fsdp_axis)

    def _top_leaf(self, p_top: dict, name: str) -> dict:
        """``p_top`` with leaf ``name`` gathered over "data" where this
        process holds a slice of it, at its use."""
        if name not in self._data_top or self._dws:
            return p_top
        return gather_data(self.executor, p_top,
                           {name: self._data_top[name]}, self._fsdp_axis)

    def _weight_stationary(self, x) -> bool:
        """Whether the MoE layers of this call on x (B_k, S, d) group
        their tokens weight-stationary (``moe.moe_groups``)."""
        cfg = self.cfg
        if not self.procs or not any(s.use_moe for s in cfg.pattern()):
            return False
        return moe_groups(cfg, self._batch, x.shape[1], self.mesh).ws

    def _tree(self, params):
        """``params``, or the held tree where None.  A tree whose leaves
        are not shaped as the held ones raises where the model holds
        shares stacked: its layers read each split leaf's parts on a
        leading axis (pass ``load_params``'s tree)."""
        if params is None:
            return self.params
        if self.shards.stacked:
            for got, held in zip((params["top"], *params["blocks"]),
                                 (self.top, *self.blocks)):
                for k, v in got.items():
                    if v.shape != held[k].shape:
                        raise ValueError(
                            f"leaf {k} {tuple(v.shape)}: this model holds "
                            f"{tuple(held[k].shape)}; pass the tree "
                            f"load_params returned")
        return params

    def _rows(self, fn, *xs, cache=None):
        """``fn(*xs, cache)``, on one card at n_data > 1 computed on each
        data shard's rows (dim 0 of ``xs``, the batch dim of ``cache``'s
        leaves, written in place) alone and joined, as the processes that
        hold the shards compute them: cuBLAS picks a product's kernel by
        its rows, so a shard's bits are then a process's.  Traced on the
        meta device the call runs whole (the dry run reads the
        reference's program)."""
        B = xs[0].shape[0]
        if self._blocks == 1 or xs[0].is_meta:
            return fn(*xs, cache)
        n = B // self._blocks
        outs = []
        for lo in range(0, B, n):
            part = None if cache is None else {
                k: v.narrow(v.dim() - 1 - _CACHE_TRAIL[k], lo, n)
                for k, v in cache.items()}
            outs.append(fn(*(x[lo:lo + n] for x in xs), part))
        return torch.cat(outs)

    def _ffn(self, spec, p, x):
        """Post-attention FFN half of a block. Returns (x, aux)."""
        cfg = self.cfg
        shards = self._shards("mlp")
        dsl = self.dsl
        if spec.use_moe:
            return moe_block(cfg, p, x, self.mesh, executor=self.executor,
                             batch=self._batch if self.procs else None,
                             shards=shards, rows=self._rows, dsl=dsl)
        y = self._rows(lambda x, _: shards.swiglu(
            rmsnorm(x, p["norm2"], cfg.norm_eps, dsl), p, "w_gate", "w_up",
            "w_down", dsl), x)
        return x + y, torch.zeros(2, dtype=torch.float32, device=x.device)

    def _layer(self, spec, p, x, positions, cache=None, cache_len=None):
        """One layer: its mixer (a data shard's rows at a time on one
        card, ``_rows``), then its FFN; the cache updated in place.
        Returns (x, aux, cache)."""
        cfg = self.cfg

        def mixer(x, positions, cache):
            if spec.kind == "attn":
                return attention_block(
                    cfg, p, x, positions, window=spec.sliding_window,
                    cache=cache, cache_len=cache_len,
                    shards=self._shards("heads"), seq=self._span,
                    dsl=self.dsl)[0]
            if spec.kind == "mamba":
                return mamba_block(cfg, p, x, cache=cache,
                                   shards=self._shards("d_inner"),
                                   dsl=self.dsl)[0]
            if spec.kind == "rwkv":
                return rwkv_block(cfg, p, x, cache=cache, mesh=self.mesh,
                                  shards=self._shards("wkv"),
                                  cm_shards=self._shards("cmix"),
                                  seq=self._span, dsl=self.dsl)[0]
            raise ValueError(spec.kind)

        x = self._rows(mixer, x, positions, cache=cache)
        if spec.kind == "rwkv":  # its channel mix is its FFN
            return x, torch.zeros(2, dtype=torch.float32,
                                  device=x.device), cache
        x, aux = self._ffn(spec, p, x)
        return x, aux, cache

    @staticmethod
    def _at(tree: dict, r: int) -> dict:
        """Repeat r's slice of a stacked dict (views)."""
        return {k: v[r] for k, v in tree.items()}

    # ------------------------- forward -------------------------

    def _embed(self, p_top, tokens, prefix_embeds=None):
        """tokens: (B, S_tok) int or None; prefix_embeds: (B, n, d) —
        vlm patch embeddings (prepended) or audio frame embeddings (the
        whole input).  Frontends are stubs, as in the reference.  Where
        the sequence is split (``_span``), this process's positions of
        the whole row: the prefix's it holds, then its tokens' looked up
        (the lookup runs on every process, its table gathered, even for
        none).  Under decode_ws the activations' part of d
        (``DSlices.chan``): the prefix's or the frames' slice, the
        table's slice looked up."""
        cfg = self.cfg
        vision = cfg.frontend == "vision" and prefix_embeds is not None
        n = prefix_embeds.shape[1] if vision else 0
        if prefix_embeds is not None:
            prefix_embeds = self.dsl.chan(prefix_embeds)
        if tokens is None:  # audio: frame embeddings are the input
            return prefix_embeds if self._span is None else \
                prefix_embeds[:, self._span.lo:self._span.hi]
        lo, hi = (0, n + tokens.shape[1]) if self._span is None \
            else (self._span.lo, self._span.hi)
        x = self._lookup(p_top, tokens[:, max(lo - n, 0):max(hi - n, 0)]
                         .long())
        if lo < n:
            x = torch.cat([prefix_embeds[:, lo:min(hi, n)].to(x.dtype), x],
                          dim=1)
        return x

    def _split_seq(self, tokens, prefix_embeds) -> None:
        """Where the sequence is split over the "model" processes
        (fsdp_sp over processes), this call's ``_span`` over the whole
        row of ``tokens`` after ``prefix_embeds`` (or the audio frames):
        model rank m's positions [m·S/tp, (m+1)·S/tp); raises, before
        any message, where tp does not divide S."""
        if not self._seq:
            return
        cfg = self.cfg
        if tokens is None:
            S = prefix_embeds.shape[1]
        else:
            S = tokens.shape[1] + (prefix_embeds.shape[1] if cfg.frontend ==
                                   "vision" and prefix_embeds is not None
                                   else 0)
        self._span = self._seq_shard(S)

    def _seq_shard(self, S: int) -> SeqShard:
        tp = self.mesh.shape["model"]
        if S % tp:
            raise ValueError(f"fsdp_sp over processes splits the sequence "
                             f"over the tp = {tp} model processes, which "
                             f"do not divide its {S} positions (the "
                             f"reference then keeps it whole on every "
                             f"model process: {QUEUE_ITEM})")
        return SeqShard(self.executor, S, tp, self.executor.rank % tp)

    def _positions(self, B: int, S: int, dev) -> torch.Tensor:
        """(B, S) int32: the absolute positions of the call's rows (this
        process's shard's where the sequence is split)."""
        lo = 0 if self._span is None else self._span.lo
        return torch.arange(lo, lo + S, dtype=torch.int32,
                            device=dev).expand(B, S)

    def _lookup(self, p_top, ids):
        """The embedding rows of ``ids``: each share looks up the ids in
        its rows and writes zeros elsewhere, and the partials are
        reduced (one nonzero term: exact).  Over processes the table is
        first gathered over "data" (its d_model columns), as every other
        leaf is at its use.  The other exact way, gathering the data
        shards' ids and trading the looked-up columns (an all-to-all of
        (B, S, d) activations, 8 MB at Qwen's prefill against the
        table's 0.3 GB), is left out: the gather is the reference's FSDP
        (GSPMD gathers the table at its use) and what the dry run prices
        (``roofline.collectives_of``), one path for the lookup and the
        tied head, and no layout of its own to hold against the stacked
        model."""
        shards = self._shards("vocab")
        p_top = self._top_leaf(p_top, "tok_embed")
        parts = []
        for j in shards.ids:
            rows = shards.of(p_top, "tok_embed", j)
            n = rows.shape[0]
            local = ids - j * n
            hit = ((local >= 0) & (local < n))[..., None]
            got = rows[local.clamp(0, n - 1)]
            parts.append(torch.where(hit, got, torch.zeros(
                (), dtype=got.dtype, device=got.device)))
        return shards.reduce(parts)

    def _repeat(self, layers, x, aux, positions):
        """One repeat of the stack: its pattern's layers (``layers``, one
        dict of that repeat's slices per position), each layer's aux
        added to the running ``aux`` in turn (the reference's carry).
        Returns (x, aux)."""
        for j, (spec, p) in enumerate(zip(self.cfg.pattern(), layers)):
            x, aux_j, _ = self._layer(spec, self._gathered(j, p), x,
                                      positions)
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
        if self.procs:  # recompute the whole repeat: its collectives too
            kw["early_stop"] = False
        aux = torch.zeros(2, dtype=torch.float32, device=x.device)
        # one unbind per stacked leaf: its backward stacks the repeats'
        # gradients once, where a slice per repeat would add a zero-padded
        # full-size gradient per repeat
        slices = tuple({k: v.unbind(0) for k, v in b.items()}
                       for b in params["blocks"])
        # the recompute runs in the backward, outside this call's rule
        # context and its state (``_call``): it enters the same ones
        rules_ctx = sharding_ctx.current()
        state = (self._batch, self._ws, self._blocks, self._span)

        def repeat(*args):
            held = (self._batch, self._ws, self._blocks, self._span)
            self._batch, self._ws, self._blocks, self._span = state
            try:
                if rules_ctx is None:
                    return self._repeat(*args)
                with use_mesh_rules(*rules_ctx):
                    return self._repeat(*args)
            finally:
                self._batch, self._ws, self._blocks, self._span = held

        for r in range(cfg.n_repeats):
            layers = tuple({k: v[r] for k, v in b.items()} for b in slices)
            if remat:
                x, aux = checkpoint(repeat, layers, x, aux, positions,
                                    use_reentrant=False, **kw)
            else:
                x, aux = self._repeat(layers, x, aux, positions)
        return x, aux

    def logits_fn(self, params, x):
        """fp32 logits over the padded vocabulary, its padding -1e30:
        each share's columns (the padding masked by the global column),
        gathered (all-gathered over processes: at B rows of S positions
        the gather holds (tp, B, S, V/tp) and the result (B, S, V) at
        once, 2·4·B·S·V bytes at its peak, 2.6 GB for Qwen's 151 936
        columns at B = 4, S = 544; prefill keeps the last position
        only).  On one card a data shard's rows at a time, as its
        processes hold them: a product by the tied embedding's transpose
        can round by the rows' count.  Under decode_ws the head's
        partials from the d-slices are summed over "data" first
        (``DSlices.dots``), so every process holds the whole row."""
        cfg = self.cfg
        dsl = self.dsl
        x = rmsnorm(x, params["top"]["final_norm"], cfg.norm_eps, dsl)
        name = "tok_embed" if cfg.tie_embeddings else "lm_head"
        shards = self._shards("vocab")
        p_top = self._top_leaf(params["top"], name)
        rows = x.shape[0] // self._blocks
        parts = []
        for j in shards.ids:
            w = shards.of(p_top, name, j)
            tie = (True,) if cfg.tie_embeddings else ()
            logits = [softcap(dsl.dots([(x[r:r + rows], w, *tie)])[0]
                              .float(), cfg.logit_softcap)
                      for r in range(0, x.shape[0], rows)]
            logits = logits[0] if len(logits) == 1 else torch.cat(logits)
            if PD.vocab_padded(cfg) != cfg.vocab:
                n = logits.shape[-1]  # this share's columns
                col = j * n + torch.arange(n, device=x.device)
                logits = torch.where(col < cfg.vocab, logits, torch.full(
                    (), -1e30, dtype=logits.dtype, device=x.device))
            parts.append(logits)
        return shards.gather(parts)

    def _forward(self, params, tokens, prefix_embeds=None, positions=None):
        params = self._tree(params)
        self._split_seq(tokens, prefix_embeds)
        x = self._embed(params["top"], tokens, prefix_embeds)
        x = constrain(x, "batch", "seq", "embed_act", site="embed")
        self._ws = self._weight_stationary(x)
        B, S, _ = x.shape
        if positions is None:
            positions = self._positions(B, S, x.device)
        x, aux = self._stack(params, x, positions)
        return self.logits_fn(params, x), aux

    def check_forward(self, what: str = "forward",
                      seq: int | None = None) -> None:
        """Raise, before any message, where ``forward`` (``what``
        "forward"), ``loss`` ("loss") or a call with a cache ("cache")
        cannot run here: with the sequence split over the "model"
        processes (fsdp_sp), a call with a cache (the cache's sequence
        over "model"), a Mamba layer (its scan over the split sequence)
        and a sequence of ``seq`` positions (the backbone's, prefix
        included) that tp does not divide.  The MoE layers under
        fsdp_sp were refused when the model was made (the reference's
        decision: "experts" and "embed" both over "model").  Under
        decode_ws over processes, ``loss`` (training under decode_ws,
        a ROADMAP item of its own)."""
        if self.procs and self._dws and what == "loss":
            raise NotImplementedError(
                f"training under decode_ws over processes (the activations' "
                f"d over \"data\" under autograd) is {QUEUE_ITEM}.3.1, "
                f"training under decode_ws")
        if not self._seq:
            return
        if what == "cache":
            raise NotImplementedError(
                f"a call with a cache under fsdp_sp over processes (the "
                f"cache's sequence over \"model\") is {QUEUE_ITEM}.4")
        if any(s.kind == "mamba" for s in self.cfg.pattern()):
            raise NotImplementedError(
                f"the fsdp_sp {what} of Mamba layers over processes (their "
                f"scan over the split sequence) is {QUEUE_ITEM}")
        if seq is not None:
            self._seq_shard(seq)

    @torch.no_grad()
    def forward(self, params=None, tokens=None, prefix_embeds=None,
                positions=None, batch: int | None = None):
        """Full-sequence forward (prefill without a cache), without
        autograd. Returns (logits fp32 (B, S, vocab_padded), aux).  Over
        processes the inputs are this process's rows of a global
        ``batch`` (``rows``), whole rows; where the sequence is split
        over the "model" processes (fsdp_sp) the logits are this
        process's positions' (``_split_seq``)."""
        self.check_forward()
        x = tokens if tokens is not None else prefix_embeds
        with self._call(x.shape[0], batch):
            return self._forward(params, tokens, prefix_embeds, positions)

    def loss(self, params, batch):
        """batch: {"tokens" or "embeds", "labels", optional "prefix"},
        tensors on the model's device.  Next-token CE for causal LMs;
        per-position CE for encoders.  Returns (loss, metrics), with
        autograd (the reference's ``Model.loss``, term for term).  Over
        processes the batch holds this process's rows of a global batch
        of rows × n_data (``rows``), and the loss and metrics are the
        global batch's, the same on every process
        (:meth:`_loss_procs`); where the sequence is split over the
        "model" processes (fsdp_sp) each computes its positions of the
        whole rows it is given."""
        cfg = self.cfg
        tokens = batch.get("tokens")
        prefix = batch.get("embeds") if cfg.frontend == "audio" else \
            batch.get("prefix")
        if self.procs:
            self.check_forward("loss")
            x = tokens if tokens is not None else prefix
            rows = x.shape[0]
            with self._call(rows, rows * self.mesh.shape["data"]):
                params = self._tree(params)
                self._split_seq(tokens, prefix)
                x = self._embed(params["top"], tokens, prefix)
                x = constrain(x, "batch", "seq", "embed_act", site="embed")
                self._ws = self._weight_stationary(x)
                B, S, _ = x.shape
                x, aux = self._stack(params, x,
                                     self._positions(B, S, x.device))
                return self._loss_procs(params, x, aux, batch)
        with self._rules():
            logits, aux = self._forward(params, tokens, prefix)
            return self._loss_inner(logits, aux, batch)

    def _targets(self, batch, S: int, dev):
        """(labels (B, S) long, weights (B, S) fp32) of ``batch`` for S
        positions: the next token at each (the last masked) for a causal
        LM, each position's own for an encoder; prefix positions carry
        none."""
        cfg = self.cfg
        labels = batch["labels"].long()
        B, S_l = labels.shape
        n_prefix = S - S_l
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
        return labels, weights

    def _held_targets(self, batch, dev):
        """``_targets`` at this call's positions (``_span``): the labels
        rolled over the whole row, prefix included, then this shard's
        cut, so a shard's last position keeps the next shard's first
        token and only the row's last is masked."""
        labels, weights = self._targets(batch, self._span.S, dev)
        lo, hi = self._span.lo, self._span.hi
        return labels[:, lo:hi], weights[:, lo:hi]

    def _loss_inner(self, logits, aux, batch):
        cfg = self.cfg
        n_moe = sum(1 for s in cfg.pattern() if s.use_moe) * cfg.n_repeats
        aux = aux / max(n_moe, 1)  # per-MoE-layer means
        logits = constrain(logits, "batch", "seq", "vocab", site="logits")
        labels, weights = self._targets(batch, logits.shape[1],
                                        logits.device)
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

    def _loss_procs(self, params, x, aux, batch):
        """The loss over processes from the stack's output x (this
        process's rows) and aux, as :meth:`_loss_inner` takes it from
        the logits, without gathering them.  The vocabulary's columns
        are reduced the reference's way: each model process takes, over
        its own columns (its share of the head, gathered over "data"),
        the max, the log-sum-exp and the label's logit (zero where the
        label is another's), and ONE all-gather over "model" of the
        (2, B, S) pair gives every process the row's log-sum-exp
        (lse = M + log Σ_j exp(lse_j − M), M the shares' largest) and
        label logit (one nonzero term).  Exact up to the order of the
        sums: lse_j's exponentials are summed over each share's columns,
        then over the shares, where one program sums the whole row at
        once.  Then ONE all-reduce over "data" of the sums of this
        process's weighted nll and weights gives the global batch's CE
        (its backward the identity: each data process's rows get their
        own gradient).  The load-balance and dropped terms are already
        the global batch's (``moe.moe_ffn``)."""
        cfg = self.cfg
        ex = self.executor
        n_moe = sum(1 for s in cfg.pattern() if s.use_moe) * cfg.n_repeats
        aux = aux / max(n_moe, 1)  # per-MoE-layer means
        span = self._span
        labels, weights = self._targets(batch, x.shape[1], x.device) \
            if span is None else self._held_targets(batch, x.device)
        shards = self._shards("vocab")
        x = shards.enter(rmsnorm(x, params["top"]["final_norm"],
                                 cfg.norm_eps))
        name = "tok_embed" if cfg.tie_embeddings else "lm_head"
        (j,) = shards.ids
        w = shards.of(self._top_leaf(params["top"], name), name, j)
        w = w.T if cfg.tie_embeddings else w
        n = w.shape[-1]
        logits = softcap((x @ w).float(), cfg.logit_softcap)
        if PD.vocab_padded(cfg) != cfg.vocab:
            col = j * n + torch.arange(n, device=x.device)
            logits = torch.where(col < cfg.vocab, logits, torch.full(
                (), -1e30, dtype=logits.dtype, device=x.device))
        zmax = torch.amax(logits, dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(logits - zmax), dim=-1)) + \
            zmax[..., 0]
        local = labels - j * n
        hit = (local >= 0) & (local < n)
        pick = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        pick = torch.where(hit, pick[..., 0], torch.zeros(
            (), dtype=pick.dtype, device=x.device))
        if shards is not WHOLE:
            both = ex.all_gather(torch.stack([lse, pick]), "model")
            top = torch.amax(both[:, 0], dim=0)
            lse = torch.log(torch.sum(torch.exp(both[:, 0] - top),
                                      dim=0)) + top
            pick = torch.sum(both[:, 1], dim=0)
        nll = (lse - pick) * weights
        sums = ex.all_reduce(torch.stack([torch.sum(nll),
                                          torch.sum(weights)]),
                             "data" if span is None else None)
        ce = sums[0] / torch.clamp(sums[1], min=1.0)
        metrics = {"ce": ce, "load_balance": aux[0], "dropped": aux[1]}
        return ce + aux[0] * 0.01, metrics

    # ------------------------- decode -------------------------

    def init_cache(self, batch: int, max_len: int, kv_dup: int = 1,
                   device=None):
        """Stacked-by-repeat caches, one entry per pattern position; the
        attention caches hold ``n_kv_heads · kv_dup`` heads (duplicated
        to the TP degree, ``launch.steps.kv_dup``).  Where a layer is
        split, a share's part instead: its kv heads
        (``params.kv_heads_of``, whatever ``kv_dup``), its wkv heads of
        RWKV6's state, its d_inner channels of Mamba's conv and h; a
        process's own, or on one card all tp shares' on a leading axis
        after the repeats' (the token shifts stay whole).

        Under decode_ws over processes ``batch`` is every row the model
        holds, and the caches hold data shard i's (``cache_rows``: the
        reference's "cache_batch" over "data"), but for RWKV6's token
        shifts, which hold every row's part of d as the activations do
        (the same bytes as B/n_data rows of all of d, and no exchange
        between the two layouts a layer)."""
        cfg = self.cfg
        dtype = PD.torch_dtype(cfg)
        r = cfg.n_repeats
        dev = self.dev if device is None else torch.device(device)
        held = batch
        if self.procs and self._dws:
            got = self.cache_rows(batch)
            batch = got.stop - got.start

        def share(part: str, n: int) -> tuple[int, tuple]:
            """A share's n of ``part``'s width, and the shares' axis."""
            shards = self._shards(part)
            if shards is WHOLE:
                return n, ()
            return n // self.split.tp, \
                (len(shards.ids),) if shards.stacked else ()

        heads, lead = share("heads", cfg.n_kv_heads * kv_dup)
        if self._shards("heads") is not WHOLE:
            lo, hi = PD.kv_heads_of(cfg, self.split, 0)
            heads = hi - lo
        di, di_lead = share("d_inner", cfg.d_inner)
        wkv, wkv_lead = share("wkv", cfg.d_model // HEAD_DIM)

        def stacked(c, lead=(), parted=()):
            return {k: v.expand(r, *(lead if k in parted else ()),
                                *v.shape).contiguous()
                    for k, v in c.items()}

        caches = []
        for spec in cfg.pattern():
            if spec.kind == "attn":
                shape = (r, *lead, batch, max_len, heads, cfg.head_dim_)
                caches.append({
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)})
            elif spec.kind == "mamba":
                caches.append(stacked(init_mamba_cache(
                    cfg, batch, dtype, dev, d_inner=di), di_lead,
                    ("conv", "h")))
            else:
                c = init_rwkv_cache(cfg, batch, dtype, dev, heads=wkv)
                if self.procs and self._dws:
                    for k in ("shift", "cm_shift"):
                        c[k] = self.dsl.chan(torch.zeros(
                            (held, 1, cfg.d_model), dtype=dtype, device=dev))
                caches.append(stacked(c, wkv_lead, ("state",)))
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
        self.check_forward("cache")
        with self._call(tokens.shape[0], batch):
            return self._serve_step_inner(params, cache, tokens, cache_len,
                                          prefix_embeds, last_only)

    def _serve_step_inner(self, params, cache, tokens, cache_len,
                          prefix_embeds, last_only):
        params = self._tree(params)
        cfg = self.cfg
        x = self._embed(params["top"], tokens, prefix_embeds)
        x = constrain(x, "batch", None, None, site="embed")
        self._ws = self._weight_stationary(x)
        B, S, _ = x.shape
        positions = cache_len + torch.arange(
            S, dtype=torch.int32, device=x.device).expand(B, S)
        for r in range(cfg.n_repeats):
            for j, spec in enumerate(cfg.pattern()):
                x, _, _ = self._layer(
                    spec, self._gathered(j, self._at(params["blocks"][j], r)),
                    x, positions, cache=self._at(cache[j], r),
                    cache_len=cache_len)
        if last_only:
            x = x[:, -1:]
        return self.logits_fn(params, x), cache
