"""Parameter definitions, from the JAX package's ``models/params.py``:
one table drives init, the logical axes and the counts.

Every layer kind declares its parameters as ``ParamDef(shape, logical
axes, init)``.  From that single source come
  * ``init_params``   — materialisation from an explicit
                        ``torch.Generator`` (the same init kinds as the
                        reference, other random numbers),
  * ``from_reference``— the JAX package's parameter tree, as numpy
                        arrays, made the port's tensors name for name,
  * ``abstract_params`` — the same tree as meta tensors (shapes and
                        dtypes, no storage: the dry run's inputs),
  * ``logical_axes``  — the tree of logical-axis tuples,
  * ``param_shardings`` — their ``sharding.rules.Sharding`` on a mesh,
  * ``count_params``  — exact totals (MODEL_FLOPS accounting).

Stacked layers: block params get a leading ("layers",) axis of length
``n_repeats``; the model loops over it (``models/model.py``).  The tree
is ``{"top": {name: tensor}, "blocks": ({name: tensor}, ...)}``, one
dict per position of the pattern unit, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.schedule import SEQ_KINDS
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.rwkv import HEAD_DIM as WKV_HEAD_DIM
from repro_torch.sharding import rules as rules_lib

LANE = 128

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "float64": torch.float64}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"  # "fan_in" | "zeros" | "ones" | "normal"
    # marks routed-expert weights for active-param accounting
    routed_expert: bool = False

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class Cut(NamedTuple):
    """The part of a leaf a model rank holds: [lo, hi) of each of
    ``blocks`` equal blocks of dim ``dim`` of the def's shape, side by
    side (``blocks`` = 2: Mamba's ``in_proj``, whose columns are [x_in |
    z], held as [its x_in columns | the same z columns])."""

    dim: int
    lo: int
    hi: int
    blocks: int = 1

    @property
    def size(self) -> int:
        return (self.hi - self.lo) * self.blocks


def vocab_padded(cfg: ModelConfig) -> int:
    """Pad vocab to a lane multiple so TP sharding always divides."""
    return round_up(cfg.vocab, LANE)


def experts_padded(cfg: ModelConfig) -> int:
    """Pad expert count to a multiple of 16 (the TP/EP degree) so the
    expert dim shards; padded experts are masked off in the router."""
    return round_up(cfg.n_experts, 16) if cfg.n_experts else 0


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


# ----------------------------- per-kind defs -----------------------------


def _ffn_defs(cfg: ModelConfig, use_moe: bool) -> dict[str, ParamDef]:
    d = cfg.d_model
    out: dict[str, ParamDef] = {"norm2": ParamDef((d,), ("norm",), "ones")}
    if not use_moe:
        ff = cfg.d_ff
        out.update(
            w_gate=ParamDef((d, ff), ("embed", "mlp")),
            w_up=ParamDef((d, ff), ("embed", "mlp")),
            w_down=ParamDef((ff, d), ("mlp", "embed")),
        )
        return out
    e = experts_padded(cfg)
    ffe = cfg.moe_d_ff
    out.update(
        router=ParamDef((d, e), ("embed", None), "normal"),
        moe_gate=ParamDef((e, d, ffe), ("experts", "embed", "expert_mlp"),
                          routed_expert=True),
        moe_up=ParamDef((e, d, ffe), ("experts", "embed", "expert_mlp"),
                        routed_expert=True),
        moe_down=ParamDef((e, ffe, d), ("experts", "expert_mlp", "embed"),
                          routed_expert=True),
    )
    if cfg.n_shared_experts:
        ffs = cfg.n_shared_experts * ffe
        out.update(
            shared_gate=ParamDef((d, ffs), ("embed", "mlp")),
            shared_up=ParamDef((d, ffs), ("embed", "mlp")),
            shared_down=ParamDef((ffs, d), ("mlp", "embed")),
        )
    return out


def _attn_defs(cfg: ModelConfig, spec: LayerSpec) -> dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.head_dim_
    h, kv = cfg.n_heads, cfg.n_kv_heads
    out = {
        "norm1": ParamDef((d,), ("norm",), "ones"),
        "wq": ParamDef((d, h * hd), ("embed", "heads")),
        "wk": ParamDef((d, kv * hd), ("embed", "kv_heads")),
        "wv": ParamDef((d, kv * hd), ("embed", "kv_heads")),
        "wo": ParamDef((h * hd, d), ("heads", "embed")),
    }
    out.update(_ffn_defs(cfg, spec.use_moe))
    return out


def _mamba_defs(cfg: ModelConfig, spec: LayerSpec) -> dict[str, ParamDef]:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    dtr = dt_rank(cfg)
    out = {
        "norm1": ParamDef((d,), ("norm",), "ones"),
        "in_proj": ParamDef((d, 2 * di), ("embed", "d_inner")),
        "conv_w": ParamDef((cfg.d_conv, di), ("conv", "d_inner")),
        "conv_b": ParamDef((di,), ("d_inner",), "zeros"),
        "x_proj": ParamDef((di, dtr + 2 * ds), ("d_inner", None)),
        "dt_proj": ParamDef((dtr, di), (None, "d_inner")),
        "dt_bias": ParamDef((di,), ("d_inner",), "zeros"),
        "a_log": ParamDef((di, ds), ("d_inner", "d_state"), "ones"),
        "d_skip": ParamDef((di,), ("d_inner",), "ones"),
        "out_proj": ParamDef((di, d), ("d_inner", "embed")),
    }
    out.update(_ffn_defs(cfg, spec.use_moe))
    return out


def _rwkv_defs(cfg: ModelConfig, spec: LayerSpec) -> dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "norm1": ParamDef((d,), ("norm",), "ones"),
        # time-mix interpolation coefficients (token shift)
        "mu_r": ParamDef((d,), ("norm",), "zeros"),
        "mu_k": ParamDef((d,), ("norm",), "zeros"),
        "mu_v": ParamDef((d,), ("norm",), "zeros"),
        "mu_w": ParamDef((d,), ("norm",), "zeros"),
        "mu_g": ParamDef((d,), ("norm",), "zeros"),
        "wr": ParamDef((d, d), ("embed", "heads")),
        "wk": ParamDef((d, d), ("embed", "heads")),
        "wv": ParamDef((d, d), ("embed", "heads")),
        "wg": ParamDef((d, d), ("embed", "heads")),
        # data-dependent decay (Finch): w_t = exp(-exp(decay(x_t)))
        "w_decay": ParamDef((d, d), ("embed", "heads"), "zeros"),
        "decay_bias": ParamDef((d,), ("heads",), "zeros"),
        "bonus_u": ParamDef((d,), ("heads",), "zeros"),
        "wo": ParamDef((d, d), ("heads", "embed")),
        # channel mix
        "norm2": ParamDef((d,), ("norm",), "ones"),
        "mu_ck": ParamDef((d,), ("norm",), "zeros"),
        "mu_cr": ParamDef((d,), ("norm",), "zeros"),
        "cm_wk": ParamDef((d, ff), ("embed", "mlp")),
        "cm_wv": ParamDef((ff, d), ("mlp", "embed")),
        "cm_wr": ParamDef((d, d), ("embed", "mlp")),
    }


_KIND_DEFS = {"attn": _attn_defs, "mamba": _mamba_defs, "rwkv": _rwkv_defs}


def block_defs(cfg: ModelConfig, spec: LayerSpec) -> dict[str, ParamDef]:
    return _KIND_DEFS[spec.kind](cfg, spec)


def model_defs(cfg: ModelConfig):
    """Full model: returns (top_level_defs, per_position_block_defs)."""
    d = cfg.d_model
    vp = vocab_padded(cfg)
    top: dict[str, ParamDef] = {}
    if cfg.frontend != "audio":
        top["tok_embed"] = ParamDef((vp, d), ("vocab", "embed"), "normal")
    top["final_norm"] = ParamDef((d,), ("norm",), "ones")
    if not cfg.tie_embeddings:
        top["lm_head"] = ParamDef((d, vp), ("embed", "vocab"))
    blocks = tuple(block_defs(cfg, spec) for spec in cfg.pattern())
    return top, blocks


def _iter_defs(cfg: ModelConfig) -> Iterator[tuple[tuple, ParamDef, bool]]:
    """Yields (path, def, stacked) for every parameter."""
    top, blocks = model_defs(cfg)
    for name, d in top.items():
        yield (name,), d, False
    for j, defs in enumerate(blocks):
        for name, d in defs.items():
            yield ("blocks", j, name), d, True


def _stacked(d: ParamDef, n_repeats: int) -> ParamDef:
    return ParamDef((n_repeats, *d.shape), ("layers", *d.axes), d.init,
                    d.routed_expert)


def _build(cfg: ModelConfig, leaf_fn):
    top, blocks = model_defs(cfg)
    r = cfg.n_repeats
    return {"top": {k: leaf_fn(d) for k, d in top.items()},
            "blocks": tuple({k: leaf_fn(_stacked(d, r))
                             for k, d in defs.items()} for defs in blocks)}


def abstract_params(cfg: ModelConfig):
    """Every parameter as a meta tensor of ``init_params``' stacked
    shape and dtype."""
    dtype = torch_dtype(cfg)
    return _build(cfg, lambda d: torch.empty(d.shape, dtype=dtype,
                                             device="meta"))


def logical_axes(cfg: ModelConfig):
    return _build(cfg, lambda d: d.axes)


def param_shardings(cfg: ModelConfig, mesh, rules):
    """The ``Sharding`` tree matching ``abstract_params``' structure."""
    return rules_lib.tree_shardings(rules, logical_axes(cfg), mesh,
                                    abstract_params(cfg))


# ----------------------------- materialise -----------------------------


def _init_leaf(path, d: ParamDef, shape, dtype, gen, dev,
               cuts: tuple = ()) -> torch.Tensor:
    """One leaf of ``shape`` (``d.shape``, or (n_repeats, *d.shape)
    stacked); with ``Cut``s of ``d.shape`` (on distinct dims), only
    that part: each slice is still drawn whole (``share_cuts``)."""
    stacked = len(shape) > len(d.shape)
    held = list(shape)
    for cut in cuts:
        held[cut.dim + stacked] = cut.size
    if path[-1] == "a_log":
        # mamba: A = -exp(a_log); init a_log = log(1..d_state)
        base = torch.log(torch.arange(1, d.shape[-1] + 1,
                                      dtype=torch.float32, device=dev))
        return base.expand(held).to(dtype).contiguous()
    if d.init == "zeros":
        return torch.zeros(held, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(held, dtype=dtype, device=dev)
    if d.init == "normal":
        scale = 0.02
    else:  # fan_in
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / math.sqrt(fan_in)
    out = torch.empty(held, dtype=dtype, device=dev)
    # one leading slice at a time: the fp32 draw of a whole stacked leaf
    # would double its bytes; a shard draws each slice whole (the
    # generator moves as the stacked model's does) and keeps its part
    draw = tuple(shape[1:]) if stacked else tuple(shape)
    for part in (out if stacked else out[None]):
        got = torch.randn(draw, generator=gen, device=dev,
                          dtype=torch.float32)
        for cut in cuts:
            got = _part(got, 0, cut)
        part.copy_(got.mul_(scale))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None, *, share=None):
    """Materialise every parameter on ``device`` (the card by default)
    from ``generator`` (a ``torch.Generator`` on that device, or a
    seed), with the reference's init kinds: N(0, 0.02) for "normal",
    N(0, 1/fan_in) for "fan_in", zeros, ones, and log(1..d_state) for
    mamba's ``a_log``.  With ``share`` = (mesh, rank) each leaf holds
    only what process ``rank`` of the (data, model) grid ``mesh`` holds
    (``shard_params`` of the whole model's weights: its model rank's
    part, then its data rank's slice of the "embed" dim), drawn one
    repeat at a time so the whole leaf never exists."""
    dev = device_lib.resolve(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))
    dtype = torch_dtype(cfg)
    r = cfg.n_repeats
    cuts = {} if share is None else share_cuts(cfg, *share)
    vals = {}
    for path, d, stacked in _iter_defs(cfg):
        shape = (r, *d.shape) if stacked else d.shape
        vals[path] = _init_leaf(path, d, shape, dtype, gen, dev,
                                cuts.get(path, ()))
    return _tree_of(cfg, vals)


def init_moe_layer(cfg: ModelConfig, seed: int = 0, device=None, *,
                   experts: tuple[int, int] | None = None,
                   data: tuple[int, int] | None = None) -> dict:
    """One MoE layer's weights (norm, router, experts, shared experts)
    from ``seed``, with ``init_params``' kinds, leaf by leaf; with
    ``experts`` = [lo, hi), those padded experts of the same weights;
    with ``data`` = (i, n), the experts' slice i of n of their "embed"
    dim (the weight-stationary grouping's FSDP slice, ``data_cut``)."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for k, d in _ffn_defs(cfg, True).items():
        cuts = ()
        if d.routed_expert:
            if experts is not None:
                cuts += (Cut(0, *experts),)
            if data is not None:
                cuts += (data_cut(d, *data),)
        out[k] = _init_leaf((k,), d, d.shape, torch_dtype(cfg), gen, dev,
                            cuts)
    return out


def mamba_mixer_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    """One Mamba mixer's leaves (``mamba_block``'s): a Mamba layer's
    defs but its FFN's."""
    ffn = _ffn_defs(cfg, False)
    return {k: d for k, d in _mamba_defs(cfg, LayerSpec("mamba")).items()
            if k not in ffn}


def init_mamba_mixer(cfg: ModelConfig, seed: int = 0, device=None, *,
                     share=None) -> dict:
    """One Mamba mixer's weights from ``seed``, with ``init_params``'
    kinds, leaf by leaf; with ``share`` = (mesh, rank), the part of the
    same weights process ``rank`` of the (data, model) grid ``mesh``
    holds (``leaf_cut``)."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    defs = mamba_mixer_defs(cfg)
    cuts = {}
    if share is not None:
        split = plan_split(cfg, share[0])
        cuts = {k: leaf_cut(cfg, split, k, d, "mamba", share[1] % split.tp)
                for k, d in defs.items()}
    return {k: _init_leaf((k,), d, d.shape, torch_dtype(cfg), gen, dev,
                          () if cuts.get(k) is None else (cuts[k],))
            for k, d in defs.items()}


def stack_layer(p: dict, cfg: ModelConfig, mesh, kind: str) -> dict:
    """One ``kind`` layer's leaves ``p`` (its defs' shapes) as one
    program holds all tp model ranks' shares: each leaf ``leaf_cut``
    cuts as its tp parts stacked on a new leading axis, as
    ``stack_parts`` holds a model's."""
    split = plan_split(cfg, mesh)
    defs = block_defs(cfg, LayerSpec(kind))
    out = {}
    for k, v in p.items():
        cuts = [leaf_cut(cfg, split, k, defs[k], kind, j)
                for j in range(split.tp)]
        out[k] = v if cuts[0] is None else _stack_parts(v, 0, cuts)
    return out


def is_expert_leaf(name: str) -> bool:
    """The routed experts' leaves: (n_repeats, e_pad, ...) stacked."""
    return name in ("moe_gate", "moe_up", "moe_down")


# ----------------------------- tensor parallel -----------------------------

QUEUE_ITEM = "ROADMAP Queue 1 item 2"


@dataclasses.dataclass(frozen=True)
class Split:
    """How a model's leaves split over its tp "model" ranks, as the
    config's rule table places them (:func:`plan_split`)."""

    tp: int
    heads: bool  # attention: q heads, their kv heads, wo's rows
    mlp: bool  # the dense FFN and the shared experts
    vocab: bool  # tok_embed's rows, lm_head's columns
    kv_dup: int  # ranks that hold each kv head (tp/n_kv where n_kv < tp)
    wkv: bool  # RWKV6's time mix: its wkv heads, wo's rows
    cmix: bool  # RWKV6's channel mix: cm_wk's columns, cm_wv's rows
    d_inner: bool  # Mamba's mixer: its d_inner channels

    @property
    def dense(self) -> bool:
        return self.heads or self.mlp or self.vocab or self.wkv or \
            self.cmix or self.d_inner


def plan_split(cfg: ModelConfig, mesh, *,
               refuse: bool = True) -> Split | None:
    """The split of ``cfg``'s dense layers over ``mesh``'s "model" axis
    under its rule table (``sharding.rules.rules_for``): attention where
    "heads" maps to "model", the dense FFN and shared experts where
    "mlp" does, the vocabulary where "vocab" does; RWKV6's wkv heads
    where "heads" does and its channel mix where "mlp" does; Mamba's
    channels where "d_inner" does.  Raises ``ValueError`` (with
    ``refuse=False``: returns None) where the table asks for a split
    that cannot be made whole: tp not dividing the heads, the d_ff, the
    shared experts' width, the padded vocabulary, the RWKV6 wkv heads or
    d_ff or Mamba's d_inner, or kv heads that no duplication gives each
    rank whole (tp neither divides nor is divided by n_kv: the reference
    then puts the cache's sequence over "model")."""
    tp = mesh.shape["model"]
    rules = rules_lib.rules_for(cfg)

    def on_model(name: str) -> bool:
        entry = rules.mesh_axes((name,), mesh)[0]
        return tp > 1 and "model" in rules_lib.entry_axes(entry)

    pattern = cfg.pattern()
    kinds = {s.kind for s in pattern}
    ffn = [s for s in pattern if s.kind != "rwkv"]
    dense_ffn = any(not s.use_moe for s in ffn)
    shared = bool(cfg.n_shared_experts) and any(s.use_moe for s in ffn)
    heads = on_model("heads") and "attn" in kinds
    mlp = on_model("mlp") and (dense_ffn or shared)
    vocab = on_model("vocab") and (cfg.frontend != "audio"
                                   or not cfg.tie_embeddings)
    wkv = on_model("heads") and "rwkv" in kinds
    cmix = on_model("mlp") and "rwkv" in kinds
    d_inner = on_model("d_inner") and "mamba" in kinds
    kv = cfg.n_kv_heads
    widths = []
    if heads:
        widths.append(("attention heads", cfg.n_heads))
    if mlp and dense_ffn:
        widths.append(("d_ff columns", cfg.d_ff))
    if mlp and shared:
        widths.append(("shared-expert columns",
                       cfg.n_shared_experts * cfg.moe_d_ff))
    if vocab:
        widths.append(("padded vocabulary rows", vocab_padded(cfg)))
    if wkv:
        widths.append(("RWKV6 wkv heads", cfg.d_model // WKV_HEAD_DIM))
    if cmix:
        widths.append(("RWKV6 channel-mix d_ff columns", cfg.d_ff))
    if d_inner:
        widths.append(("Mamba d_inner channels", cfg.d_inner))
    problems = [f"tp = {tp} model processes do not divide the {n} {what}"
                for what, n in widths if n % tp]
    if heads and kv % tp and tp % kv:
        problems.append(f"no duplication of the {kv} kv heads gives each of "
                        f"tp = {tp} model processes whole kv heads; the "
                        f"cache's sequence over \"model\" (cache_seq_tp) "
                        f"is {QUEUE_ITEM}")
    if problems:
        if refuse:
            raise ValueError(problems[0])
        return None
    return Split(tp, heads, mlp, vocab,
                 tp // kv if heads and kv < tp else 1, wkv, cmix, d_inner)


def q_heads_of(cfg: ModelConfig, split: Split, j: int) -> tuple[int, int]:
    """[lo, hi): the q heads model rank j holds."""
    n = cfg.n_heads // split.tp
    return j * n, (j + 1) * n


def kv_heads_of(cfg: ModelConfig, split: Split, j: int) -> tuple[int, int]:
    """[lo, hi): the kv heads model rank j's q heads read, whole: n_kv/tp
    of them, or where n_kv < tp the one that kv_dup ranks share."""
    n = max(1, cfg.n_kv_heads // split.tp)
    lo = j * n // split.kv_dup
    return lo, lo + n


def held_whole(name: str, kind: str) -> bool:
    """Leaves every model rank holds whole although the rule table
    splits them: RWKV6's ``cm_wr`` (d × d over "mlp"), whose split
    product ``rr`` the whole channel mix reads, so that a split would
    all-gather it a layer."""
    return kind == "rwkv" and name == "cm_wr"


def _cut_by(split: Split, name: str, kind: str) -> bool:
    """Whether ``split`` cuts a dim of logical axis ``name`` in a
    ``kind`` layer ("top" for the top-level leaves)."""
    if kind == "rwkv":
        return {"heads": split.wkv, "mlp": split.cmix}.get(name, False)
    return {"heads": split.heads, "kv_heads": split.heads,
            "mlp": split.mlp, "vocab": split.vocab, "experts": True,
            "d_inner": split.d_inner}.get(name, False)


def leaf_cut(cfg: ModelConfig, split: Split, name: str, d: ParamDef,
             kind: str, j: int) -> Cut | None:
    """The ``Cut`` of leaf ``name`` of def ``d`` of a ``kind`` layer
    ("top" for the top-level leaves) that model rank j holds, or None
    where it holds the leaf whole.  Attention heads split by whole
    heads, kv heads by ``kv_heads_of``, RWKV6's wkv heads (whole heads
    of 64, d/tp of each dim over "heads") and the rest evenly;
    ``in_proj``'s x_in and z each evenly, so a rank holds x_in's
    channels and their gates."""
    if held_whole(name, kind) or split.tp == 1:
        return None
    hd = cfg.head_dim_
    for dim, axis in enumerate(d.axes):
        if not _cut_by(split, axis, kind):
            continue
        if axis == "heads" and kind == "attn":
            lo, hi = q_heads_of(cfg, split, j)
            return Cut(dim, lo * hd, hi * hd)
        if axis == "kv_heads":
            lo, hi = kv_heads_of(cfg, split, j)
            return Cut(dim, lo * hd, hi * hd)
        blocks = 2 if name == "in_proj" else 1
        n = d.shape[dim] // blocks // split.tp
        return Cut(dim, j * n, (j + 1) * n, blocks)
    return None


def tp_cuts(cfg: ModelConfig, mesh, rank: int) -> dict:
    """{path: ``Cut`` of the def's shape} of every leaf process ``rank``
    of the (data, model) grid ``mesh`` holds a part of, read against the
    rule table's shardings (``param_shardings``): every dim it cuts is
    one they split over "model" (kv heads aside: the table may split a
    head's columns, a process holds whole heads), and every leaf they
    split over "model" is cut but those ``held_whole``.  Dims over
    "data" (FSDP) are ``data_cuts``'; ``share_cuts`` gives both."""
    split = plan_split(cfg, mesh)
    j = rank % split.tp
    specs = param_shardings(cfg, mesh, rules_lib.rules_for(cfg))
    kinds = [s.kind for s in cfg.pattern()]
    out = {}
    for path, d, stacked in _iter_defs(cfg):
        spec = specs["top"][path[0]] if len(path) == 1 \
            else specs["blocks"][path[1]][path[2]]
        entries = spec.spec[int(stacked):]
        # the "embed" dim over "model" (fsdp_sp's FSDP over the whole
        # grid) is the data cut's
        on = [i for i, e in enumerate(entries)
              if "model" in rules_lib.entry_axes(e) and split.tp > 1
              and d.axes[i] != "embed"]
        kind = "top" if len(path) == 1 else kinds[path[1]]
        cut = leaf_cut(cfg, split, path[-1], d, kind, j)
        name = "/".join(map(str, path))
        if cut is None:
            if on and not held_whole(path[-1], kind):
                raise ValueError(f"{name}: the rule table splits dim "
                                 f"{on[0]} over \"model\", the process "
                                 f"would hold it whole")
            continue
        if d.axes[cut.dim] != "kv_heads" and on != [cut.dim]:
            raise ValueError(f"{name}: cut on dim {cut.dim}, the rule "
                             f"table splits {on} over \"model\"")
        out[path] = cut
    return out


def data_cut(d: ParamDef, i: int, n: int) -> Cut:
    """Slice i of n of the "embed" dim of def ``d``."""
    dim = d.axes.index("embed")
    size = d.shape[dim] // n
    return Cut(dim, i * size, (i + 1) * size)


def fsdp_axes(cfg: ModelConfig, mesh) -> dict:
    """{path: the mesh axes, in the mesh's order, that split the leaf's
    "embed" dim} for every leaf the rule table's shardings
    (``param_shardings``, after ``divisible_spec``) split over more
    than one rank there (FSDP): ("data",) under the "tp" table, the
    whole grid ("data", "model") under fsdp_sp's.  Every dim they split
    over "data" must be the "embed" dim."""
    specs = param_shardings(cfg, mesh, rules_lib.rules_for(cfg))
    out = {}
    for path, d, stacked in _iter_defs(cfg):
        spec = specs["top"][path[0]] if len(path) == 1 \
            else specs["blocks"][path[1]][path[2]]
        entries = spec.spec[int(stacked):]
        on = [j for j, e in enumerate(entries)
              if "data" in rules_lib.entry_axes(e)]
        if on and [d.axes[j] for j in on] != ["embed"]:
            raise ValueError(f"{'/'.join(map(str, path))}: the rule table "
                             f"splits dims {on} ({[d.axes[j] for j in on]})"
                             f" over \"data\"; FSDP cuts the \"embed\" dim "
                             f"alone")
        if "embed" not in d.axes:
            continue
        axes = rules_lib.entry_axes(entries[d.axes.index("embed")])
        if math.prod(mesh.shape[a] for a in axes) > 1:
            out[path] = tuple(a for a in mesh.axis_names if a in axes)
    return out


def fsdp_axis(cfg: ModelConfig, mesh) -> str | None:
    """The ``SPMDExecutor`` axis the FSDP slices are gathered over
    (``models.shards.gather_data``) and the leaves whole over it have
    their gradients summed over (``launch.steps.sync_grads``): "data"
    under the "tp" table, None (every process) under fsdp_sp's, whose
    "embed" is over the whole grid.  Raises ``ValueError`` where the
    leaves split over different groups."""
    groups = set(fsdp_axes(cfg, mesh).values())
    if cfg.sharding_strategy == "fsdp_sp":
        groups.add(tuple(mesh.axis_names))
    if len(groups) > 1:
        raise ValueError(f"the leaves' \"embed\" dims split over the axes "
                         f"{sorted(groups)}, one group a layer takes one "
                         f"({QUEUE_ITEM})")
    axes = groups.pop() if groups else ("data",)
    return axes[0] if len(axes) == 1 else None


def ws_slices(cfg: ModelConfig, mesh) -> int:
    """The slices decode_ws's activations hold d in: n_data where its
    rule table puts "embed_act" over "data" and n_data divides d (the
    weights' "embed" dims cut alike, ``data_cuts``), else 1 (whole)."""
    if cfg.sharding_strategy != "decode_ws":
        return 1
    rules = rules_lib.rules_for(cfg)
    axes = rules_lib.entry_axes(rules.mesh_axes(("embed_act",), mesh)[0])
    n = math.prod(mesh.shape[a] for a in axes if a in mesh.shape)
    return n if n > 1 and cfg.d_model % n == 0 and \
        tuple(a for a in axes if a in mesh.shape) == ("data",) else 1


def seq_split(cfg: ModelConfig, mesh) -> bool:
    """Whether a model over processes splits the sequence over its
    "model" processes: fsdp_sp's "seq" over "model", at tp > 1."""
    return cfg.sharding_strategy == "fsdp_sp" and mesh.shape["model"] > 1


def data_cuts(cfg: ModelConfig, mesh, rank: int) -> dict:
    """{path: ``Cut`` of the def's shape} of every leaf process ``rank``
    of the (data, model) grid ``mesh`` holds a slice of (FSDP): its
    position's slice of the "embed" dim over the axes that split it
    (``fsdp_axes``), the n slices in the group's order (over "data":
    data rank i = rank // tp's d/n_data; over the whole grid, fsdp_sp:
    process k's d/(n_data·tp)).  Read against the rule table's
    shardings: every dim they split over "data" is cut, and it must be
    the "embed" dim; a leaf whose "embed" dim ``divisible_spec`` leaves
    whole stays whole.  A cut on a leaf the model cut also splits
    (``tp_cuts``) is on another dim."""
    pos = dict(zip(mesh.axis_names, np.unravel_index(
        rank, tuple(mesh.shape[a] for a in mesh.axis_names))))
    defs = {path: d for path, d, _ in _iter_defs(cfg)}
    out = {}
    for path, axes in fsdp_axes(cfg, mesh).items():
        i, n = 0, 1
        for a in axes:
            i, n = i * mesh.shape[a] + int(pos[a]), n * mesh.shape[a]
        out[path] = data_cut(defs[path], i, n)
    return out


def share_cuts(cfg: ModelConfig, mesh, rank: int) -> dict:
    """{path: (``Cut``, ...)}: the cuts of every leaf process ``rank``
    holds a part of, model rank j's (``tp_cuts``) then data rank i's
    (``data_cuts``), each of the def's shape, on distinct dims."""
    model, data = tp_cuts(cfg, mesh, rank), data_cuts(cfg, mesh, rank)
    return {path: tuple(c for c in (model.get(path), data.get(path))
                        if c is not None) for path in {**model, **data}}


def _held_elems(d: ParamDef, cuts) -> int:
    n = math.prod(d.shape)
    for cut in cuts:
        n = n // d.shape[cut.dim] * cut.size
    return n


def share_nbytes(cfg: ModelConfig, mesh, rank: int) -> dict:
    """``nbytes`` of process ``rank``'s share (``shard_params``),
    counted from the config without a tensor."""
    cuts = share_cuts(cfg, mesh, rank)
    size = torch_dtype(cfg).itemsize
    out = {"dense": 0, "experts": 0}
    for path, d, stacked in _iter_defs(cfg):
        n = _held_elems(d, cuts.get(path, ())) * \
            (cfg.n_repeats if stacked else 1)
        out["experts" if d.routed_expert else "dense"] += n * size
    return out


def fsdp_gathers(cfg: ModelConfig, mesh, rank: int, *,
                 ws: bool = False) -> dict:
    """The all-gathers over "data" one model call of process ``rank``
    makes (``models.shards.gather_data``): one a layer whose leaves it
    holds a data slice of (the layer's slices in one flat bucket), one
    at the embedding and one at the head (each use of a tied table);
    with ``ws`` (the call's MoE grouping is weight-stationary,
    ``moe.moe_groups``) the routed experts stay out of the buckets,
    sliced, as the dry run leaves them (``roofline.collectives_of``).
    Under decode_ws (``ws_slices`` > 1) the weights stay put: a bucket
    holds a MoE layer's routed experts alone, in a call that is not
    weight-stationary, and nothing else is gathered.
    Returns {"calls", "bytes", "buckets"}: ``bytes`` what the process
    sends, its slices' bytes, ``buckets`` each gather's in call order
    (the embedding, each repeat's positions, the head); a gather over g
    data ranks lands g − 1 times that, the dry run's wire bytes of the
    leaves' all-gathers where the process holds what their shardings
    give a rank (not so for the leaves ``held_whole`` over "model", nor
    for kv heads that several model ranks share)."""
    cuts = share_cuts(cfg, mesh, rank)
    data = data_cuts(cfg, mesh, rank)
    size = torch_dtype(cfg).itemsize
    dws = ws_slices(cfg, mesh) > 1
    top = {}
    layers = [0] * len(cfg.pattern())
    for path, d, stacked in _iter_defs(cfg):
        if path not in data or (ws and d.routed_expert) or \
                (dws and not d.routed_expert):
            continue
        held = _held_elems(d, cuts[path]) * size
        if stacked:
            layers[path[1]] += held
        else:
            top[path[0]] = held
    head = "tok_embed" if cfg.tie_embeddings else "lm_head"
    buckets = [top["tok_embed"]] if "tok_embed" in top \
        and cfg.frontend != "audio" else []
    layers = [b for _ in range(cfg.n_repeats) for b in layers if b]
    buckets += layers
    buckets += [top[head]] if head in top else []
    return {"calls": len(buckets), "bytes": sum(buckets),
            "buckets": buckets, "layers": layers}


def ws_collectives(cfg: ModelConfig, mesh, rank: int, *, batch: int,
                   seq: int, last_only: bool = True,
                   prefix: int = 0) -> dict:
    """The collectives one serving call of process ``rank`` makes under
    decode_ws over the (data, model) grid ``mesh`` (``Model.serve_step``
    or ``forward`` on a global batch of ``batch`` rows of ``seq``
    positions, ``prefix`` of them a vision prefix; the logits of the
    last position alone with ``last_only``), by the kind
    ``SPMDExecutor.traffic`` counts it under and the mesh axis it spans:
    {(kind, axis): {"calls", "bytes"}}, ``bytes`` what the process puts
    in (an all-gather's slice, an all-reduce's or all-to-all's whole
    input).  n = ``ws_slices`` data slices of d; each activation is
    (B, S, d/n).

    - ("ws_reduce", "data"): a norm's fp32 sums of squares (four a
      layer and the final norm's), the partials of each group of
      products from d (attention's q, k and v; RWKV6's five, then its
      channel mix's k and r; Mamba's in_proj; the FFN's gate and up, or
      the MoE router and the shared experts' gate and up), the head's,
      and a weight-stationary MoE call's (g, u) partials.
    - ("ws_gather", "data"): each mixer core's output from its cache's
      rows back to every row (where n_data divides B); a MoE call that
      is not weight-stationary joins its tokens' d and, where the rows
      split, gathers its output's rows.
    - ("all_reduce", "model"): the partials into d of the products split
      over "model" (attention's and RWKV6's wo, cm_wv, Mamba's x_proj and
      out_proj, w_down and shared_down), and the embedding's.
    - ("all_gather", "model"): the logits' vocabulary; a MoE call's
      token-split output; ("all_gather", axis) its router probabilities
      and kept flags over ``moe.dispatch_plan``'s axis.
    - ("all_to_all", "model"): a MoE call's two; ("fsdp_gather",
      "data"): its experts, where it is not weight-stationary.

    The dispatch scans' messages are the plans' and not counted here."""
    from repro_torch.models import moe

    D, tp = mesh.shape["data"], mesh.shape["model"]
    n = ws_slices(cfg, mesh)
    split = plan_split(cfg, mesh)
    size = torch_dtype(cfg).itemsize
    B, S, d, r = batch, seq, cfg.d_model, cfg.n_repeats
    d_l = d // n
    S_out = 1 if last_only else S
    rows = B // D if D > 1 and B % D == 0 else B
    gather_rows = rows < B
    out: dict = {}

    def add(kind, axis, nbytes, calls=1, group=2):
        if group > 1 and calls:
            got = out.setdefault((kind, axis), {"calls": 0, "bytes": 0})
            got["calls"] += calls
            got["bytes"] += calls * int(nbytes)

    def part(flag: bool, width: int) -> int:
        return width // tp if flag and tp > 1 else width

    act = B * S * d_l * size
    norm = 4 * B * S

    def reduce_d(width, calls=1):  # partials from d, one group
        add("ws_reduce", "data", B * S * width * size, calls, n)

    def rows_back(width, calls=1):  # a core's rows to every row
        if gather_rows:
            add("ws_gather", "data", rows * S * width * size, calls, n)

    def into_d(flag, calls=1):  # a product into d split over "model"
        add("all_reduce", "model", act, calls * int(flag), tp)

    if cfg.frontend != "audio" and split.vocab:
        add("all_reduce", "model", B * (S - prefix) * d_l * size, 1, tp)
    hd = cfg.head_dim_
    for spec in cfg.pattern():
        if spec.kind == "attn":
            q = part(split.heads, cfg.n_heads)
            lo, hi = kv_heads_of(cfg, split, rank % tp) if split.heads \
                else (0, cfg.n_kv_heads)
            add("ws_reduce", "data", norm, r, n)
            reduce_d((q + 2 * (hi - lo)) * hd, r)
            rows_back(q * hd, r)
            into_d(split.heads, r)
        elif spec.kind == "mamba":
            di = part(split.d_inner, cfg.d_inner)
            add("ws_reduce", "data", norm, r, n)
            reduce_d(2 * di, r)
            if split.d_inner:
                add("all_reduce", "model", rows * S * (dt_rank(cfg) + 2 *
                                                     cfg.d_state) * size,
                    r, tp)
            rows_back(di, r)
            into_d(split.d_inner, r)
        else:  # rwkv: its channel mix is its FFN
            dh = part(split.wkv, d)
            add("ws_reduce", "data", norm, 2 * r, n)
            reduce_d(5 * dh, r)
            rows_back(dh, r)
            into_d(split.wkv, r)
            reduce_d(part(split.cmix, cfg.d_ff) + d, r)
            into_d(split.cmix, r)
            continue
        add("ws_reduce", "data", norm, r, n)
        if not spec.use_moe:
            reduce_d(2 * part(split.mlp, cfg.d_ff), r)
            into_d(split.mlp, r)
            continue
        e_pad, k = experts_padded(cfg), cfg.top_k
        reduce_d(e_pad, r)  # the router
        if cfg.n_shared_experts:
            reduce_d(2 * part(split.mlp, cfg.n_shared_experts *
                              cfg.moe_d_ff), r)
            into_d(split.mlp, r)
        gr = moe.moe_groups(cfg, B, S, mesh)
        cap = moe.capacity(cfg, gr.n0, k)
        axis = moe.dispatch_plan(cfg, B, S, mesh).axis
        n_axis = 1 if axis is False else D * tp if axis is None \
            else mesh.shape[axis]
        width = d_l if gr.ws else d
        add("all_to_all", "model", e_pad * cap * width * size, 2 * r, tp)
        if gr.ws:
            add("ws_reduce", "data", 2 * (e_pad // tp) * tp * cap *
                cfg.moe_d_ff * size, r, n)
        else:
            add("ws_gather", "data", act, r, n)
            if gather_rows:
                add("ws_gather", "data", rows * S * d * size, r, n)
        if gr.token_split:
            add("all_gather", "model", gr.n0 * width * size, r, tp)
        add("all_gather", axis, gr.n0 * (e_pad + k) * 4, r, n_axis)
    # the experts of a call that is not weight-stationary
    g = fsdp_gathers(cfg, mesh, rank, ws=moe_ws(cfg, B, S, mesh))
    for nbytes in g["buckets"]:
        add("fsdp_gather", "data", nbytes, 1, D)
    # the head: the final norm, its partials, the vocabulary
    add("ws_reduce", "data", 4 * B * S_out, 1, n)
    v = part(split.vocab, vocab_padded(cfg))
    add("ws_reduce", "data", B * S_out * v * size, 1, n)
    if split.vocab:
        add("all_gather", "model", B * S_out * v * 4, 1, tp)
    return out


def moe_ws(cfg: ModelConfig, B: int, S: int, mesh) -> bool:
    """Whether a (B, S) call's MoE layers group weight-stationary
    (``moe.moe_groups``; False for a model without them)."""
    from repro_torch.models import moe

    return any(s.use_moe for s in cfg.pattern()) and \
        moe.moe_groups(cfg, B, S, mesh).ws


def all_reduces(cfg: ModelConfig, split: Split | None, *,
                ws: bool = False) -> int:
    """The all-reduces one call of a model split as ``split`` makes:
    over "model" the embedding's, and each layer's row-split products:
    attention's wo, RWKV6's wo and cm_wv, Mamba's x_proj and out_proj,
    and the FFN's (or shared experts') w_down; with ``ws`` (the call's
    MoE grouping is weight-stationary over more than one data rank) one
    more a MoE layer, over "data": its experts' d-sliced partials."""
    n = cfg.n_repeats * sum(s.use_moe for s in cfg.pattern()) if ws else 0
    if split is None:
        return n
    n += int(split.vocab and cfg.frontend != "audio")
    for spec in cfg.pattern():
        ffn = spec.kind != "rwkv" and (not spec.use_moe
                                       or bool(cfg.n_shared_experts))
        mixer = {"attn": int(split.heads),
                 "rwkv": int(split.wkv) + int(split.cmix),
                 "mamba": 2 * int(split.d_inner)}[spec.kind]
        n += cfg.n_repeats * (mixer + int(split.mlp and ffn))
    return n


def train_collectives(cfg: ModelConfig, mesh, rank: int, *, batch: int,
                      seq: int, remat: bool | None = None) -> dict:
    """The collectives one training step of process ``rank`` of the
    (data, model) grid ``mesh`` makes (``launch.steps.make_train_step``
    over processes, a global batch of ``batch`` rows of ``seq``
    tokens), by the kind ``SPMDExecutor.traffic`` counts it under:
    {kind: {"calls", "bytes"}}, ``bytes`` what the process puts in
    (a gather's slice, an all-to-all's or reduce-scatter's whole input).
    With ``remat`` (the config's by default) each repeat's forward runs
    again in the backward, collectives included.

    - "fsdp_gather": the weight buckets of a call (``fsdp_gathers``),
      the layers' again in the recompute; "fsdp_scatter": one
      reduce-scatter of each forward bucket's gradient, n_data times
      its bytes.
    - "all_reduce": over "model" a call's (``all_reduces``), the
      repeats' again in the recompute, and in the backward one a split
      layer's input ("enter": attention's, the FFN's and the shared
      experts' normed input, RWKV6's five shifted inputs in one bucket
      and its channel mix's, Mamba's normed input and its summed
      (dt_raw, B, C)) and one of the head's input; a weight-stationary
      MoE layer's partials over "data" forward, recomputed and
      backward; the CE's two sums over "data".
    - "all_gather": a MoE layer's (the weight-stationary tokens over
      "data", its outputs over "data", y over "model" under token
      split, every group's router probabilities and kept flags) forward
      and recomputed, and in the backward the token split's slices'
      gradients (tokens, then probabilities); the CE's (2, B, S)
      log-sum-exp and label logit over "model".
    - "reduce_scatter": the weight-stationary tokens' and outputs'
      gradients over "data"; "all_to_all": a MoE layer's two, forward,
      recomputed and backward.
    - "grad_sync": one all-reduce over "data" of the leaves whole over
      it; "kv_sync": one all-gather over "model" of the kv heads'
      gradients where model processes share a kv head; "grad_norm":
      the norm's one all-reduce over every process.

    The dispatch scans' messages are the plans' (``moe.dispatch_plan``)
    and not counted here."""
    from repro_torch.models import moe

    remat = cfg.remat if remat is None else remat
    D, tp = mesh.shape["data"], mesh.shape["model"]
    size = torch_dtype(cfg).itemsize
    split = plan_split(cfg, mesh)
    B_k, d, r = batch // D, cfg.d_model, cfg.n_repeats
    # the backbone's positions: a vision prefix's before the tokens
    n_pre = cfg.n_prefix if cfg.frontend == "vision" else 0
    S = seq + n_pre
    reps = 1 + int(bool(remat))
    act = B_k * S * d * size
    kinds = ("fsdp_gather", "fsdp_scatter", "all_reduce", "all_gather",
             "reduce_scatter", "all_to_all", "grad_sync", "kv_sync",
             "grad_norm", *SEQ_KINDS)
    out = {k: {"calls": 0, "bytes": 0} for k in kinds}

    def add(kind, nbytes, calls=1, group=2):
        if group > 1 and calls:
            out[kind]["calls"] += calls
            out[kind]["bytes"] += calls * int(nbytes)

    pattern = cfg.pattern()
    uses_moe = any(s.use_moe for s in pattern)
    gr = moe.moe_groups(cfg, batch, S, mesh) if uses_moe else None
    ws = bool(gr is not None and gr.ws)
    g = fsdp_gathers(cfg, mesh, rank, ws=ws)
    out["fsdp_gather"] = {
        "calls": len(g["buckets"]) + (reps - 1) * len(g["layers"]),
        "bytes": g["bytes"] + (reps - 1) * sum(g["layers"])}
    n_fsdp = D * tp if fsdp_axis(cfg, mesh) is None else D
    out["fsdp_scatter"] = {"calls": len(g["buckets"]),
                           "bytes": n_fsdp * g["bytes"]}
    # over "model": each layer's leaves forward, its enters backward
    dbc = B_k * S * (dt_rank(cfg) + 2 * cfg.d_state) * size
    fwd, bwd = [], []
    for spec in pattern:
        ffn = spec.kind != "rwkv" and split.mlp and \
            (not spec.use_moe or bool(cfg.n_shared_experts))
        if spec.kind == "attn" and split.heads:
            fwd.append(act)
            bwd.append(act)
        if spec.kind == "rwkv":
            if split.wkv:
                fwd.append(act)
                bwd.append(5 * act)
            if split.cmix:
                fwd.append(act)
                bwd.append(act)
        if spec.kind == "mamba" and split.d_inner:
            fwd += [dbc, act]
            bwd += [act, dbc]
        if ffn:
            fwd.append(act)
            bwd.append(act)
    for nbytes in fwd:
        add("all_reduce", nbytes, r * reps, tp)
    for nbytes in bwd:
        add("all_reduce", nbytes, r, tp)
    if split.vocab and cfg.frontend != "audio":
        add("all_reduce", act * seq // S, 1, tp)  # the lookup's tokens
    if split.vocab:
        add("all_reduce", act, 1, tp)  # the head's input, backward
        add("all_gather", 2 * B_k * S * 4, 1, tp)  # the CE's pair
    add("all_reduce", 8, 1, n_fsdp)  # the CE's sums
    if seq_split(cfg, mesh):
        # the sequence over "model": attention's k and v gathered, the
        # RWKV6 token shifts' last rows (two a layer), each forward,
        # recomputed, and reduce-scattered back in the backward
        S_all = S
        n_attn = r * sum(s.kind == "attn" for s in pattern)
        n_shift = 2 * r * sum(s.kind == "rwkv" for s in pattern)
        kv = 2 * B_k * (S_all // tp) * cfg.n_kv_heads * cfg.head_dim_ * size
        row = B_k * d * size
        add("seq_kv", kv, n_attn * reps, tp)
        add("seq_kv_scatter", tp * kv, n_attn, tp)
        add("seq_shift", row, n_shift * reps, tp)
        add("seq_shift_scatter", tp * row, n_shift, tp)
    n_moe = r * sum(s.use_moe for s in pattern)
    if n_moe:
        k, e_pad = cfg.top_k, experts_padded(cfg)
        n0, cap = gr.n0, moe.capacity(cfg, gr.n0, cfg.top_k)
        e_local = e_pad // tp
        held = B_k < batch
        axis = moe.dispatch_plan(cfg, batch, S, mesh).axis
        n_axis = 1 if axis is False else D * tp if axis is None \
            else mesh.shape[axis]
        add("all_to_all", e_pad * cap * d * size, 2 * n_moe * (reps + 1),
            tp)
        if ws and held:
            add("all_gather", act, n_moe * reps, D)
            add("reduce_scatter", batch * S * d * size, n_moe, D)
        if ws and D > 1:
            add("all_reduce", 2 * e_local * tp * cap * cfg.moe_d_ff * size,
                n_moe * (reps + 1), D)
            out_l = e_local * tp * cap * (d // D) * size
            add("all_gather", out_l, n_moe * reps, D)
            add("reduce_scatter", D * out_l, n_moe, D)
        if gr.token_split:
            add("all_gather", n0 * d * size, n_moe * reps, tp)  # y
            add("all_gather", n0 * d * size, n_moe, tp)  # the tokens'
            add("all_gather", n0 * e_pad * 4, n_moe, tp)  # the probs'
        add("all_gather", n0 * (e_pad + k) * 4, n_moe * reps, n_axis)
    # after the backward
    cuts = share_cuts(cfg, mesh, rank)
    data = data_cuts(cfg, mesh, rank)
    whole = sum(_held_elems(dd, cuts.get(path, ()))
                * (r if stacked else 1)
                for path, dd, stacked in _iter_defs(cfg) if path not in data)
    add("grad_sync", whole * size, 1, n_fsdp)
    paths, group = kv_shared(cfg, mesh, rank)
    kv = sum(_held_elems(dd, cuts.get(path, ())) * r
             for path, dd, _ in _iter_defs(cfg) if path in paths)
    add("kv_sync", kv * size, 1, len(group))
    add("grad_norm", 4, 1, D * tp)
    return out


def kv_shared(cfg: ModelConfig, mesh, rank: int) -> tuple[set, tuple]:
    """(the attention leaves whose kv heads model process ``rank`` shares
    with others, where fewer kv heads than model processes make
    ``plan_split`` duplicate them; the model positions sharing them, in
    order).  Each such process's gradient of them is a part (its q
    heads'), summed over the group by the train step.  No leaf and the
    process alone where none is shared."""
    split = plan_split(cfg, mesh)
    j = rank % mesh.shape["model"]
    if not split.heads or split.kv_dup == 1:
        return set(), (j,)
    mine = kv_heads_of(cfg, split, j)
    group = tuple(q for q in range(split.tp)
                  if kv_heads_of(cfg, split, q) == mine)
    paths = {path for path, d, _ in _iter_defs(cfg)
             if len(path) == 3 and "kv_heads" in d.axes}
    return paths, group


def norm_owner(cfg: ModelConfig, mesh, rank: int) -> set:
    """The leaves (paths) whose share process ``rank`` counts in the
    global norm: each part of a leaf once over all processes.  A leaf
    whole over "model" (or a kv head that model processes share) is
    counted by the first model process holding it, one whole over
    "data" by data rank 0; a slice over the whole grid (fsdp_sp) by
    the process holding it."""
    tp = mesh.shape["model"]
    i, j = divmod(rank, tp)
    model = tp_cuts(cfg, mesh, rank)
    before = tp_cuts(cfg, mesh, rank - 1) if j else {}
    data = fsdp_axes(cfg, mesh)
    out = set()
    for path, _, _ in _iter_defs(cfg):
        cut, axes = model.get(path), data.get(path, ())
        first = (j == 0 or "model" in axes) if cut is None \
            else before.get(path) != cut
        if first and ("data" in axes or i == 0):
            out.add(path)
    return out


def leaf_paths(tree) -> list:
    """The paths (("top" name,) or ("blocks", j, name)) of a parameter
    tree's leaves in ``_tree``'s order, which the train step's gradient
    list follows."""
    from repro_torch import _tree

    keyed = {"top": {k: k for k in tree["top"]},
             "blocks": tuple({k: f"blocks/{j}/{k}" for k in b}
                             for j, b in enumerate(tree["blocks"]))}
    return [tuple(int(x) if x.isdigit() else x for x in key.split("/"))
            for key in _tree.leaves(keyed)]


def join_shares(shares: list, cfg: ModelConfig, mesh):
    """The whole tree from every process's share (``shares[k]`` process
    k's, as ``shard_params`` cuts it; tensors or numpy arrays, bf16 as
    ``ml_dtypes``): each part written where its cuts put it, so
    ``join_shares([shard_params(t, cfg, mesh, k) for k ...])`` is ``t``.
    A part several processes hold is taken from the last."""
    cuts = [share_cuts(cfg, mesh, k) for k in range(len(shares))]

    def tensor(v):
        return v if isinstance(v, torch.Tensor) \
            else device_lib.leaf_to_torch(v, "cpu")

    shares = [{"top": {k: tensor(v) for k, v in t["top"].items()},
               "blocks": tuple({k: tensor(v) for k, v in b.items()}
                               for b in t["blocks"])} for t in shares]

    def leaf(tree, path):
        return tree["top"][path[0]] if len(path) == 1 \
            else tree["blocks"][path[1]][path[2]]

    def join(path, d, lead, v):
        whole = torch.empty((*v.shape[:lead], *d.shape), dtype=v.dtype,
                            device=v.device)
        for k, tree in enumerate(shares):
            idx = [torch.arange(n) for n in whole.shape]
            for cut in cuts[k].get(path, ()):
                width = d.shape[cut.dim] // cut.blocks
                idx[lead + cut.dim] = torch.cat([
                    torch.arange(b * width + cut.lo, b * width + cut.hi)
                    for b in range(cut.blocks)])
            n = whole.dim()
            whole[tuple(ix.reshape([-1 if a == m else 1 for a in range(n)])
                        for m, ix in enumerate(idx))] = leaf(tree, path)
        return whole

    return _map_leaves(shares[0], cfg, join)


def _map_leaves(tree, cfg: ModelConfig, fn):
    """``tree`` with each leaf v of def d at path replaced by ``fn(path,
    d, lead, v)``, ``lead`` the leading dims past the def's ("layers")."""
    defs = {path: d for path, d, _ in _iter_defs(cfg)}

    def take(path, v):
        d = defs[path]
        return fn(path, d, v.dim() - len(d.shape), v)

    top = {k: take((k,), v) for k, v in tree["top"].items()}
    blocks = tuple({k: take(("blocks", j, k), v) for k, v in b.items()}
                   for j, b in enumerate(tree["blocks"]))
    return {"top": top, "blocks": blocks}


def _stack_parts(v, lead: int, cuts: list) -> torch.Tensor:
    """The ``cuts`` of ``v`` stacked on a new axis after its ``lead``
    dims, each part contiguous."""
    return torch.stack([_part(v, lead, c) for c in cuts], dim=lead)


def _part(v, lead: int, cut: Cut):
    """``cut`` of ``v``, whose def's dims start after ``lead`` dims."""
    dim, n = cut.dim + lead, cut.hi - cut.lo
    if cut.blocks == 1:
        return v.narrow(dim, cut.lo, n)
    width = v.shape[dim] // cut.blocks
    return torch.cat([v.narrow(dim, b * width + cut.lo, n)
                      for b in range(cut.blocks)], dim=dim)


def shard_params(tree, cfg: ModelConfig, mesh, rank: int):
    """The parameters process ``rank`` of a (data, model) grid holds
    (``share_cuts``), each part copied out so the whole leaf can be
    freed.  Over "model" (``tp_cuts``), model rank j = rank mod tp's
    heads of attention (its q heads, the kv heads they read, wo's
    matching rows), its d_ff/tp columns of the dense FFN's and the
    shared experts' gate and up and rows of their down, its
    vocab_padded/tp rows of tok_embed and columns of lm_head, its
    e_pad/tp routed experts, its RWKV6 wkv heads (wr, wk, wv, wg and
    w_decay columns, decay_bias, bonus_u, wo's rows) and channel-mix
    d_ff (cm_wk's columns, cm_wv's rows), its Mamba d_inner channels
    (in_proj's x_in and z columns, conv, x_proj's and a_log's rows,
    dt_proj's columns, dt_bias, d_skip, out_proj's rows); the norms, the
    router and ``cm_wr`` whole.  Then over "data" (FSDP,
    ``data_cuts``), data rank i = rank // tp's d/n_data of every leaf's
    "embed" dim the rule table splits: the projections into and out of
    d_model, the router, the routed experts, the embedding and the head;
    the norms, the token shifts and the mixers' inner leaves whole.
    Under fsdp_sp nothing is cut over "model" alone and the "embed"
    slices are process ``rank``'s of the whole grid."""
    cuts = share_cuts(cfg, mesh, rank)

    def take(path, d, lead, v):
        if path not in cuts:
            return v
        for cut in cuts[path]:
            v = _part(v, lead, cut)
        return v.clone()

    return _map_leaves(tree, cfg, take)


def stack_parts(tree, cfg: ModelConfig, mesh):
    """``tree`` as one program holds all tp model ranks' shares of the
    dense layers: each leaf that ``tp_cuts`` cuts, routed experts
    aside, as the tp parts stacked on a new axis after "layers" (part j
    is model rank j's, contiguous, as its process holds it, gathered
    over "data"); every other leaf as it is, uncopied.  The data cut
    does not apply: one program holds every data rank."""
    tp = mesh.shape["model"]
    cuts = [tp_cuts(cfg, mesh, j) for j in range(tp)]

    def take(path, d, lead, v):
        if path not in cuts[0] or d.routed_expert:
            return v
        if tuple(v.shape[lead:]) != d.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: "
                             f"{tuple(v.shape)} is not the whole leaf "
                             f"{d.shape}")
        return _stack_parts(v, lead, [c[path] for c in cuts])

    return _map_leaves(tree, cfg, take)


def nbytes(tree) -> dict:
    """{"dense": bytes, "experts": bytes} of a parameter tree: of a
    process's share (``shard_params``), what that process holds."""
    out = {"dense": 0, "experts": 0}
    for k, v in tree["top"].items():
        out["dense"] += v.numel() * v.element_size()
    for b in tree["blocks"]:
        for k, v in b.items():
            out["experts" if is_expert_leaf(k) else "dense"] += \
                v.numel() * v.element_size()
    return out


def _tree_of(cfg: ModelConfig, vals: dict):
    top = {p[0]: v for p, v in vals.items() if len(p) == 1}
    blocks = tuple(
        {p[2]: v for p, v in vals.items() if len(p) == 3 and p[1] == j}
        for j in range(len(cfg.pattern())))
    return {"top": top, "blocks": blocks}


def from_reference(tree, cfg: ModelConfig, device=None):
    """The JAX package's parameter tree (``{"top": ..., "blocks":
    (...)}``, leaves as numpy arrays, bf16 through ``ml_dtypes``) as the
    port's tensors on ``device``, name for name; every leaf must have
    the shape this config's tables give it."""
    dev = device_lib.resolve(device)
    r = cfg.n_repeats
    vals = {}
    for path, d, stacked in _iter_defs(cfg):
        leaf = tree["top"][path[0]] if len(path) == 1 \
            else tree["blocks"][path[1]][path[2]]
        want = (r, *d.shape) if stacked else d.shape
        if tuple(np.shape(leaf)) != tuple(want):
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{tuple(np.shape(leaf))}, the config gives "
                             f"{tuple(want)}")
        vals[path] = device_lib.leaf_to_torch(leaf, dev)
    return _tree_of(cfg, vals)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = 0
    r = cfg.n_repeats
    e_pad = experts_padded(cfg)
    for _, d, stacked in _iter_defs(cfg):
        n = int(np.prod(d.shape)) * (r if stacked else 1)
        if active_only and d.routed_expert and e_pad:
            n = n * cfg.top_k // e_pad
        total += n
    return total
