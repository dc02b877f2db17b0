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
from typing import Iterator

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models.config import LayerSpec, ModelConfig
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
               experts: tuple[int, int] | None = None) -> torch.Tensor:
    if path[-1] == "a_log":
        # mamba: A = -exp(a_log); init a_log = log(1..d_state)
        base = torch.log(torch.arange(1, d.shape[-1] + 1,
                                      dtype=torch.float32, device=dev))
        return base.expand(shape).to(dtype).contiguous()
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if d.init == "normal":
        scale = 0.02
    else:  # fan_in
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / math.sqrt(fan_in)
    stacked = len(shape) > len(d.shape)
    lo, hi, held = 0, None, list(shape)
    if experts is not None and d.routed_expert:  # the expert axis, cut
        lo, hi = experts
        held[int(stacked)] = hi - lo
    out = torch.empty(held, dtype=dtype, device=dev)
    # one leading slice at a time: the fp32 draw of a whole stacked
    # expert leaf would double its bytes; a shard draws each slice whole
    # (the generator moves as the stacked model's does) and keeps its
    # experts
    draw = tuple(shape[1:]) if stacked else tuple(shape)
    for part in (out if stacked else out[None]):
        part.copy_(torch.randn(draw, generator=gen, device=dev,
                               dtype=torch.float32)[lo:hi].mul_(scale))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None, *, experts: tuple[int, int] | None = None):
    """Materialise every parameter on ``device`` (the card by default)
    from ``generator`` (a ``torch.Generator`` on that device, or a
    seed), with the reference's init kinds: N(0, 0.02) for "normal",
    N(0, 1/fan_in) for "fan_in", zeros, ones, and log(1..d_state) for
    mamba's ``a_log``.  With ``experts`` = [lo, hi) the routed-expert
    leaves hold only those padded experts: the whole model's weights,
    sliced (``shard_params``), drawn one repeat at a time so the whole
    leaf never exists."""
    dev = device_lib.resolve(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))
    dtype = torch_dtype(cfg)
    r = cfg.n_repeats
    vals = {}
    for path, d, stacked in _iter_defs(cfg):
        shape = (r, *d.shape) if stacked else d.shape
        vals[path] = _init_leaf(path, d, shape, dtype, gen, dev, experts)
    return _tree_of(cfg, vals)


def init_moe_layer(cfg: ModelConfig, seed: int = 0, device=None, *,
                   experts: tuple[int, int] | None = None) -> dict:
    """One MoE layer's weights (norm, router, experts, shared experts)
    from ``seed``, with ``init_params``' kinds, leaf by leaf; with
    ``experts`` = [lo, hi), those padded experts of the same weights."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return {k: _init_leaf((k,), d, d.shape, torch_dtype(cfg), gen, dev,
                          experts)
            for k, d in _ffn_defs(cfg, True).items()}


def is_expert_leaf(name: str) -> bool:
    """The routed experts' leaves: (n_repeats, e_pad, ...) stacked."""
    return name in ("moe_gate", "moe_up", "moe_down")


def shard_params(tree, cfg: ModelConfig, mesh, rank: int):
    """The parameters process ``rank`` of a (data, model) grid holds:
    the padded experts [j·e_local, (j+1)·e_local) of every routed-expert
    leaf, j = rank mod tp and e_local = e_pad/tp, copied out so the
    whole leaf can be freed; every other leaf whole (the batch is split
    over the data processes, and the dense layers are not split over
    the model ones)."""
    from repro_torch.models.moe import expert_range

    lo, hi = expert_range(cfg, mesh, rank)
    blocks = tuple({k: v[:, lo:hi].clone() if is_expert_leaf(k) else v
                    for k, v in b.items()} for b in tree["blocks"])
    return {"top": dict(tree["top"]), "blocks": blocks}


def nbytes(tree) -> dict:
    """{"dense": bytes, "experts": bytes} of a parameter tree."""
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
