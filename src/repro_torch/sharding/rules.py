"""Logical-axis partition rules, from the JAX package's
``sharding/rules.py`` (MaxText-style).

Every parameter and activation dimension carries a *logical* axis name;
a rule table maps logical names to mesh axes.  Changing a sharding
strategy means editing ONE table, not the model code.

The tables are the reference's, key for key.  A spec is a :class:`P`
(one entry a tensor dim: None, a mesh axis name, or a tuple of names),
and :meth:`Rules.shard` gives a :class:`Sharding` of a
``launch.mesh.HostMesh``: the rank grid has names and sizes and no
devices, so a sharding says what each rank would hold
(:meth:`Sharding.shard_shape`) and how ``torch.distributed.tensor``
would place it (:meth:`Sharding.placements`).  A mesh axis may shard at
most one dim of a tensor: :class:`Sharding` refuses a spec that maps an
axis twice, as ``jax.sharding.NamedSharding`` does.
"""

from __future__ import annotations

import dataclasses
import math

# Mesh axis names (see launch/mesh.py):
#   single pod: ("data", "model");  multi-pod: ("pod", "data", "model")

# logical axis -> mesh axes (None = replicated)
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": ("data",),  # context/sequence parallelism (long_500k)
    "embed_act": None,
    # params — FSDP shards the d_model ("embed") dim over the data axes,
    # TP shards heads / ffn-hidden / experts / vocab over "model".
    "embed": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),  # after duplication to TP degree
    "head_dim": None,
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),  # expert parallelism
    "expert_mlp": None,
    "d_inner": ("model",),  # mamba inner channels
    "d_state": None,
    "conv": None,
    "norm": None,
    # kv cache
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_kv": ("model",),
    # long-context decode: sequence-sharded cache
    "cache_seq_shard": ("data",),
    # fallback when kv heads can't shard over TP: cache seq over model
    "cache_seq_tp": ("model",),
    # layer-stacking axis of stacked params
    "layers": None,
}


class P(tuple):
    """A partition spec: one entry a tensor dim, each None (replicated),
    a mesh axis name, or a tuple of names (sharded over their product,
    outermost first); dims past the end are replicated.  The
    counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: ``spec``'s entry j names the mesh
    axes that split dim j.  Raises ``ValueError`` when a mesh axis
    shards two dims (the reference's ``DuplicateSpecError``) or is not
    in the mesh."""

    mesh: object
    spec: P

    def __post_init__(self):
        seen = set()
        for entry in self.spec:
            for a in entry_axes(entry):
                if a not in self.mesh.axis_names:
                    raise ValueError(f"mesh axis {a!r} of {self.spec} is "
                                     f"not in {self.mesh.axis_names}")
                if a in seen:
                    raise ValueError(f"mesh axis {a!r} shards more than one "
                                     f"dim of {self.spec}")
                seen.add(a)

    def _entries(self, ndim: int) -> tuple:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than the "
                             f"{ndim} dims it shards")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape each rank holds of a tensor of ``shape`` (every
        sharded dim must divide by its axes' product)."""
        sizes = self.mesh.shape
        out = []
        for dim, entry in zip(shape, self._entries(len(shape))):
            n = math.prod(sizes[a] for a in entry_axes(entry))
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {entry} ({n} ranks)")
            out.append(dim // n)
        return tuple(out)

    def placements(self) -> tuple:
        """``torch.distributed.tensor`` placements, one a mesh dim in
        mesh order: ``Shard(dim)`` for the tensor dim the axis splits,
        else ``Replicate()``.  A dim split over several axes is sharded
        over each of them, outermost first."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {a: j for j, entry in enumerate(self.spec)
                  for a in entry_axes(entry)}
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in self.mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class Rules:
    table: dict
    # (mesh, logical, shape) -> (spec, one rank's shape): sharding.ctx's
    # cache of resolved constraints
    resolved: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)

    def mesh_axes(self, logical: tuple[str | None, ...], mesh) -> P:
        """Resolve logical axes to a spec valid for ``mesh``.

        Axes absent from the mesh (e.g. "pod" on a single-pod mesh) are
        dropped; a dim is left unsharded unless its size is divisible by
        the product of the mapped mesh axis sizes (caller guarantees the
        shape, :func:`divisible_spec` guarantees validity).
        """
        spec = []
        for name in logical:
            if name is None:
                spec.append(None)
                continue
            mapped = self.table.get(name)
            if mapped is None:
                spec.append(None)
                continue
            if isinstance(mapped, str):
                mapped = (mapped,)
            present = tuple(a for a in mapped if a in mesh.axis_names)
            spec.append(present if present else None)
        return P(*spec)

    def shard(self, logical, mesh, shape=None) -> Sharding:
        """The :class:`Sharding` of a logical annotation; if ``shape``
        is given, drop shardings that do not divide the dimension."""
        spec = self.mesh_axes(logical, mesh)
        if shape is not None:
            spec = divisible_spec(spec, shape, mesh)
        return Sharding(mesh, spec)


def divisible_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop mesh axes from a spec wherever they don't divide the dim."""
    axis_size = mesh.shape
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                           - len(spec))):
        if entry is None:
            out.append(None)
            continue
        kept = []
        prod = 1
        for a in entry_axes(entry):
            if dim % (prod * axis_size[a]) == 0:
                kept.append(a)
                prod *= axis_size[a]
        out.append(tuple(kept) if kept else None)
    return P(*out)


DEFAULT = Rules(DEFAULT_RULES)

# FSDP + sequence-parallel strategy: no tensor parallelism — the "model"
# axis carries (a) an extra FSDP factor for params/optimizer and (b) the
# activations' SEQUENCE dim, so the only per-layer collectives are the
# FSDP weight all-gathers and a KV gather in attention, instead of TP's
# 2+ full-activation reductions per layer.
FSDP_SP_RULES = dict(
    DEFAULT_RULES,
    **{
        "seq": ("model",),
        "seq_kv": None,
        "embed": ("pod", "data", "model"),
        "heads": None,
        "kv_heads": None,
        "mlp": None,
        "d_inner": None,
        "vocab": None,
        "experts": ("model",),  # EP stays on "model"
        "cache_kv": None,
        "cache_seq": ("model",),
    },
)

# Weight-stationary decode: small per-step token counts make moving
# activations cheaper than FSDP-gathering weights — activations carry
# their d_model dim sharded over the FSDP axes (partial-sum matmuls +
# tiny psums), batch replicated outside attention; weights never move.
# The KV cache stays batch-sharded.
DECODE_WS_RULES = dict(
    DEFAULT_RULES,
    **{
        "batch": None,
        "embed_act": ("pod", "data"),
    },
)

STRATEGIES = {
    "tp": Rules(DEFAULT_RULES),
    "fsdp_sp": Rules(FSDP_SP_RULES),
    "decode_ws": Rules(DECODE_WS_RULES),
}


def rules_for(cfg) -> Rules:
    return STRATEGIES[getattr(cfg, "sharding_strategy", "tp")]


def make_rules(**overrides) -> Rules:
    table = dict(DEFAULT_RULES)
    table.update(overrides)
    return Rules(table)


def _is_logical(x) -> bool:
    """A logical annotation: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and not isinstance(x, P) \
        and all(isinstance(e, (str, type(None))) for e in x)


def map_logical(fn, logical_tree, *trees):
    """``fn(annotation, *leaves)`` over a tree of logical annotations
    and same-structure trees (dicts, tuples, lists)."""
    if _is_logical(logical_tree):
        return fn(logical_tree, *trees)
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, *(t[k] for t in trees))
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, (tuple, list)):
        out = [map_logical(fn, v, *(t[i] for t in trees))
               for i, v in enumerate(logical_tree)]
        return type(logical_tree)(out)
    raise TypeError(f"not a logical annotation: {logical_tree!r}")


def tree_shardings(rules: Rules, logical_tree, mesh, shape_tree):
    """Map a tree of logical annotations + shapes (tensors, or anything
    with ``.shape``) to :class:`Sharding`\\ s."""
    return map_logical(lambda log, shp: rules.shard(log, mesh, shp.shape),
                       logical_tree, shape_tree)
