"""Step functions and abstract input specs for every (arch × shape) cell,
from the JAX package's ``launch/steps.py``.

``make_train_step`` builds the training step: the loss and its
gradient through autograd (the scans' backward is the
``affine_chunk_bwd`` kernel), clipping at a global norm of 1.0, the
cosine schedule and AdamW.  ``make_serve_step`` builds the prefill,
decode and encode steps.

``input_specs`` gives every input of a cell's step as a meta tensor
(shape and dtype, no storage), with its ``sharding.rules.Sharding`` on
the mesh and the donated arguments, leaf for leaf as the reference's.
``lower_cell`` pairs them with the step; its ``compile()`` runs the
step once on ``torch.device("meta")`` with the model at ranks = the
mesh, counting every aten op's FLOPs (``FlopCounterMode``) and tensor
bytes and the high-water mark of live storage, and the kernels' meta
rules count their launches and bytes (``kernels/scan_engine.py``).
Nothing here touches data.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _tree
from repro_torch.core import schedule as schedule_lib
from repro_torch.kernels import scan_engine
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import params as PD
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_lr)
from repro_torch.sharding import ctx as sharding_ctx
from repro_torch.sharding import rules as rules_lib
from repro_torch.sharding.rules import P, Sharding


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq: int
    batch: int
    long_context: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           long_context=True),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; else the recorded reason."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.long_context and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("pure full-attention arch: 500k context needs "
                       "sub-quadratic attention (DESIGN.md shape skips)")
    return True, ""


def kv_dup(cfg: ModelConfig, mesh) -> int:
    """KV-head duplication factor for the decode cache: the smallest
    count that (a) the TP degree divides (so the cache heads dim shards)
    and (b) divides n_heads (so GQA grouping stays exact), else 1 (the
    cache then shards its sequence over "model", cache_logical_axes)."""
    tp = mesh.shape["model"]
    kv, h = cfg.n_kv_heads, cfg.n_heads
    for dup in range(1, h // kv + 1):
        kvd = kv * dup
        if kvd % tp == 0 and h % kvd == 0:
            return dup
    return 1


def kv_shardable(cfg: ModelConfig, mesh) -> bool:
    tp = mesh.shape["model"]
    kvd = cfg.n_kv_heads * kv_dup(cfg, mesh)
    return kvd % tp == 0


# --------------------------- abstract inputs ---------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, B: int, S: int):
    """S is the TOTAL backbone sequence; vlm frontends consume the first
    n_prefix positions with stub patch embeddings."""
    dt = PD.torch_dtype(cfg)
    out = {}
    if cfg.frontend == "audio":
        out["embeds"] = _meta((B, S, cfg.d_model), dt)
        out["labels"] = _meta((B, S), torch.int32)
        return out
    s_tok = S - (cfg.n_prefix if cfg.frontend == "vision" else 0)
    out["tokens"] = _meta((B, s_tok), torch.int32)
    out["labels"] = _meta((B, s_tok), torch.int32)
    if cfg.frontend == "vision":
        out["prefix"] = _meta((B, cfg.n_prefix, cfg.d_model), dt)
    return out


def _batch_entry(mesh, B: int):
    bt = mesh_lib.batch_axes(mesh)
    return bt if (bt and B % mesh_lib.data_degree(mesh) == 0) else None


def _batch_shardings(batch_specs, mesh, B: int):
    b_entry = _batch_entry(mesh, B)
    return {k: Sharding(mesh, P(b_entry, *([None] * (s.dim() - 1))))
            for k, s in batch_specs.items()}


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(abstract_args, arg_shardings, donate_argnums) for the cell."""
    model = Model(cfg, mesh, device="meta")
    rules = rules_lib.rules_for(cfg)
    params = model.abstract_params()
    p_shard = model.param_shardings(rules)
    scalar = Sharding(mesh, P())

    if shape.kind == "train":
        opt = adamw_init(params)
        opt_shard = AdamWState(step=scalar, mu=p_shard, nu=p_shard)
        batch = _batch_specs(cfg, shape.batch, shape.seq)
        b_shard = _batch_shardings(batch, mesh, shape.batch)
        step_ct = _meta((), torch.int32)
        return ((params, opt, batch, step_ct),
                (p_shard, opt_shard, b_shard, scalar), (0, 1))

    b_entry = _batch_entry(mesh, shape.batch)
    dt = PD.torch_dtype(cfg)
    if cfg.encoder_only:  # prefill == one full encode pass, no cache
        embeds = _meta((shape.batch, shape.seq, cfg.d_model), dt)
        return ((params, embeds),
                (p_shard, Sharding(mesh, P(b_entry, None, None))), ())

    cache = model.abstract_cache(shape.batch, shape.seq, kv_dup(cfg, mesh))
    cache_axes = model.cache_logical_axes(shape.long_context,
                                          kv_shardable(cfg, mesh))
    cache_shard = rules_lib.tree_shardings(rules, cache_axes, mesh, cache)
    S_in = shape.seq if shape.kind == "prefill" else 1
    vlm_prefill = cfg.frontend == "vision" and shape.kind == "prefill"
    s_tok = S_in - (cfg.n_prefix if vlm_prefill else 0)
    args = [params, cache, _meta((shape.batch, s_tok), torch.int32),
            _meta((), torch.int32)]
    shardings = [p_shard, cache_shard, Sharding(mesh, P(b_entry, None)),
                 scalar]
    if vlm_prefill:
        args.append(_meta((shape.batch, cfg.n_prefix, cfg.d_model), dt))
        shardings.append(Sharding(mesh, P(b_entry, None, None)))
    return tuple(args), tuple(shardings), (1,)


# --------------------------- step functions ---------------------------


def make_train_step(cfg: ModelConfig, ranks=(1, 1), *, lr_peak: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    device=None, model: Model | None = None,
                    on_grads=None):
    """The train step ``(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``.  ``params`` are leaves that take gradients
    (``Model.load_params(tree, trainable=True)``); the batch holds
    tensors on the model's device.  Parameters and moments are updated
    in place (``optim.adamw``).  ``metrics`` holds the loss's (``ce``,
    ``load_balance``, ``dropped``) and ``loss``, ``grad_norm`` and
    ``lr``, as detached 0-d tensors on the device: reading them is the
    caller's synchronise.

    Over processes (``model`` over an ``SPMDExecutor``) ``params`` and
    the moments are this process's share and ``batch`` its rows of the
    global batch (``Model.rows``): the loss is the global batch's, its
    gradients the share's (:func:`sync_grads`), clipped by the global
    norm over every process's share (``params.norm_owner``, one
    all-reduce), and AdamW, elementwise, updates the share; the metrics
    are the global ones, the same on every process.  ``on_grads(step,
    grads)``, when given, sees each step's gradient tree before the
    clip."""
    model = model if model is not None else Model(cfg, ranks, device)
    norm_kw = {}
    if model.procs:
        ex, mesh = model.executor, model.mesh
        owner = PD.norm_owner(model.cfg, mesh, ex.rank)
        norm_kw["reduce"] = lambda t: ex.all_reduce(
            t.reshape(1), None, kind="grad_norm")[0]

    def train_step(params, opt_state, batch, step):
        leaves, treedef = _tree.flatten(params)
        frozen = [i for i, p in enumerate(leaves) if not p.requires_grad]
        if frozen:
            raise ValueError(f"{len(frozen)} parameter leaves take no "
                             f"gradient: load them with trainable=True")
        loss, metrics = model.loss(params, batch)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, got)]
        if model.procs:
            paths = PD.leaf_paths(params)
            got = sync_grads(model, paths, got)
            norm_kw["owned"] = [path in owner for path in paths]
        grads = _tree.unflatten(treedef, got)
        del got
        if on_grads is not None:
            on_grads(step, grads)
        grads, gnorm = clip_by_global_norm(grads, 1.0, **norm_kw)
        lr = cosine_lr(torch.as_tensor(step, device=loss.device),
                       peak=lr_peak, warmup=warmup, total=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(loss=loss.detach(), grad_norm=gnorm, lr=lr)
        return params, opt_state, out

    return train_step


def sync_grads(model: Model, paths: list, grads: list) -> list:
    """A process's gradients (one a leaf of ``paths``, its share's)
    made its share's of the global batch's gradient: those of the
    leaves whole over "data" (no ``params.data_cuts`` cut), each data
    process's part, all-reduced over "data" in ONE flat bucket (counted
    as "grad_sync"; over every process under fsdp_sp, whose processes
    each compute their rows' positions, ``params.fsdp_axis``); those of
    kv heads that model processes share (``params.kv_shared``), each
    process's part from its q heads, summed
    over the processes sharing them in their order (one all-gather over
    "model" of their bucket, counted as "kv_sync").  The gathered
    leaves' gradients were reduce-scattered in the backward
    (``models.shards.gather_data``) and those of leaves whole over
    "model" are the same on every model process."""
    ex, cfg, mesh = model.executor, model.cfg, model.mesh
    out = list(grads)

    def bucket(idx, fn):
        if not idx:
            return
        flat = fn(torch.cat([out[i].reshape(-1) for i in idx]))
        off = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[off:off + n].view(out[i].shape)
            off += n

    axis = model._fsdp_axis
    if len(ex.axis_group(axis)[0]) > 1:
        data = PD.data_cuts(cfg, mesh, ex.rank)
        bucket([i for i, path in enumerate(paths) if path not in data],
               lambda t: ex.all_reduce(t, axis, kind="grad_sync"))
    shared, group = PD.kv_shared(cfg, mesh, ex.rank)
    if len(group) > 1:
        def kv_sum(t):
            got = ex.all_gather(t, "model", kind="kv_sync")
            return schedule_lib.sum_in_order(got[list(group)])

        bucket([i for i, path in enumerate(paths) if path in shared],
               kv_sum)
    return out


def make_serve_step(cfg: ModelConfig, ranks, shape: ShapeSpec, *,
                    device=None, model: Model | None = None):
    """The cell's serving step: ``encode_step(params, embeds) ->
    logits`` for an encoder, else ``serve_step(params, cache, tokens,
    cache_len[, prefix]) -> (logits, cache)`` (prefill keeps the last
    position's logits only; ``cache_len`` an int)."""
    model = model if model is not None else Model(cfg, ranks, device)
    last_only = shape.kind == "prefill"

    if cfg.encoder_only:
        def encode_step(params, embeds):
            logits, _ = model.forward(params, None, embeds)
            return logits

        return encode_step

    if cfg.frontend == "vision" and shape.kind == "prefill":
        def serve_step(params, cache, tokens, cache_len, prefix):
            return model.serve_step(params, cache, tokens, cache_len,
                                    prefix_embeds=prefix,
                                    last_only=last_only)
    else:
        def serve_step(params, cache, tokens, cache_len):
            return model.serve_step(params, cache, tokens, cache_len,
                                    last_only=last_only)

    return serve_step


def make_step(cfg: ModelConfig, ranks, shape: ShapeSpec, *, device=None,
              model: Model | None = None):
    if shape.kind == "train":
        return make_train_step(cfg, ranks, device=device, model=model)
    return make_serve_step(cfg, ranks, shape, device=device, model=model)


# --------------------------- the meta trace ---------------------------


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op touches of ``t``: its elements, or its storage where
    that is smaller (a broadcast view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


# ops that move no data: allocation, aliasing, metadata
FREE_OPS = frozenset((
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_unsafe_view", "detach", "lift_fresh", "alias",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_local_scalar_dense"))


def _moves_no_data(func) -> bool:
    name = func._overloadpacket.__name__
    if name in FREE_OPS:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class MetaTrace(TorchDispatchMode):
    """Counts, over the ops dispatched while it is on: the bytes each op
    touches (each distinct tensor among its inputs and outputs once;
    views and metadata ops nothing) and the high-water mark of the
    bytes of live storages, from ``args``' storages (live throughout)
    and every storage an op makes (live until it is freed)."""

    def __init__(self, args=()):
        super().__init__()
        self.bytes = 0
        self.live: dict = {}
        self.cur = self.peak = 0
        for t in _tensors(args):
            self._hold(t, watch=False)
        self.arg_bytes = self.cur

    def _hold(self, t: torch.Tensor, watch: bool = True) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        if watch:
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.cur -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if outs and not _moves_no_data(func):
            seen = {id(t): t for t in _tensors(args) + _tensors(kwargs)
                    + outs}
            self.bytes += sum(tensor_bytes(t) for t in seen.values())
        for t in outs:
            self._hold(t)
        return out


def _shard_bytes(args, shardings) -> int:
    """Σ over leaves of one rank's bytes under their shardings."""
    total = 0

    def walk(a, s):
        nonlocal total
        if isinstance(a, torch.Tensor):
            total += math.prod(s.shard_shape(tuple(a.shape))) \
                * a.element_size()
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
        elif isinstance(a, (tuple, list)):
            for x, y in zip(a, s):
                walk(x, y)

    walk(args, shardings)
    return total


@dataclasses.dataclass
class Compiled:
    """What the meta trace of one cell's step counted.  Totals are the
    stacked trace's (every rank of the mesh in one program); per device
    is the even split, except the argument bytes, which are exact
    (their shardings)."""

    cfg: ModelConfig
    shape: ShapeSpec
    mesh: object
    n_devices: int
    flops_total: float
    bytes_total: float
    argument_bytes: int  # one rank's, exact
    argument_bytes_total: int
    output_bytes_total: int
    peak_bytes_total: int  # the trace's high-water of live storage
    kernel_launches: dict
    kernel_bytes: dict
    constraints: list  # (site, local shape, spec, itemsize)
    n_forward: int  # constraints[:n_forward] were recorded in forward
    scan_stats: schedule_lib.CollectiveStats
    param_shardings: dict
    abstract_params: dict
    seconds: float

    def cost_analysis(self) -> dict:
        """One rank's FLOPs and bytes accessed (the even split)."""
        n = self.n_devices
        return {"flops": self.flops_total / n,
                "bytes accessed": self.bytes_total / n}

    def memory_analysis(self) -> dict:
        """One rank's argument, output, temp and peak bytes: arguments
        exact, the rest the even split of the trace's."""
        n = self.n_devices
        temp = max(self.peak_bytes_total - self.argument_bytes_total, 0) / n
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes_total / n,
                "temp_bytes": temp,
                "peak_bytes": self.argument_bytes + temp}

    def collectives(self):
        """The priced collectives of one rank (``roofline.collectives_of``)."""
        from repro_torch.launch import roofline as rl

        return rl.collectives_of(
            self.cfg, self.mesh, shardings=self.param_shardings,
            logical=PD.logical_axes(self.cfg),
            abstract=self.abstract_params, constraints=self.constraints,
            n_forward=self.n_forward, scan_stats=self.scan_stats,
            train=self.shape.kind == "train")


@dataclasses.dataclass
class Lowered:
    """A cell's step with its abstract inputs, ready to be traced."""

    cfg: ModelConfig
    shape: ShapeSpec
    mesh: object
    args: tuple
    shardings: tuple
    donate: tuple

    def compile(self) -> Compiled:
        """Run the step once on meta tensors, counting."""
        t0 = time.perf_counter()
        cfg, shape, mesh = self.cfg, self.shape, self.mesh
        model = Model(cfg, mesh, device="meta")
        train = shape.kind == "train"
        args = list(self.args)
        params = model.load_params(args[0], trainable=train)
        args[0] = params
        if train:
            args[3] = 0
        elif not cfg.encoder_only:
            # the cache's valid length: nothing before a prefill, all
            # but the last position before a decode step
            args[3] = 0 if shape.kind == "prefill" else shape.seq - 1
        step = make_step(cfg, mesh, shape, model=model)
        records: list = []
        marks = {"n_forward": None}
        if train:
            loss = model.loss

            def counted_loss(*a, **kw):
                out = loss(*a, **kw)
                marks["n_forward"] = len(records)
                return out

            model.loss = counted_loss
        scan_engine.reset_meta_counts()
        trace = MetaTrace(args)
        with schedule_lib.collect_stats() as stats, \
                sharding_ctx.record_constraints(records), \
                FlopCounterMode(display=False) as flops, trace:
            out = step(*args)
            out_bytes = sum(tensor_bytes(t) for t in _tensors(out))
            del out
        n_fwd = marks["n_forward"]
        return Compiled(
            cfg=cfg, shape=shape, mesh=mesh, n_devices=mesh.size,
            flops_total=float(flops.get_total_flops()),
            bytes_total=float(trace.bytes + sum(
                scan_engine.META_BYTES.values())),
            argument_bytes=_shard_bytes(self.args, self.shardings),
            argument_bytes_total=trace.arg_bytes,
            output_bytes_total=out_bytes, peak_bytes_total=trace.peak,
            kernel_launches=dict(scan_engine.META_LAUNCHES),
            kernel_bytes=dict(scan_engine.META_BYTES),
            constraints=records,
            n_forward=len(records) if n_fwd is None else n_fwd,
            scan_stats=stats,
            param_shardings=self.shardings[0],
            abstract_params=self.args[0],
            seconds=time.perf_counter() - t0)


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Lowered:
    """One cell's step and abstract inputs; ``.compile()`` traces it."""
    args, shardings, donate = input_specs(cfg, shape, mesh)
    return Lowered(cfg, shape, mesh, args, shardings, donate)
