"""Roofline terms of a dry-run cell on one NVIDIA H100, from the JAX
package's ``launch/roofline.py``.

Three terms per (arch × shape × mesh), in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = Σ_ops wire_bytes(op) / LINK_BW

FLOPs and bytes come from the dry run's meta trace (``launch/steps.py``
``Compiled.cost_analysis``).  The card's constants are here, each with
its source; nothing else in the port states a peak.

The port has no HLO to parse, so :func:`collectives_of` prices the
collectives a sharded run of the step would issue from the cell's
shardings and from what the trace recorded, under the reference's op
names and ring wire-byte formulas (g ranks in the group; ``out`` the
op's output on one rank; ``roofline.py:150-160`` of the JAX package):

    all-reduce         2 · out · (g − 1)/g
    all-gather         out · (g − 1)/g
    reduce-scatter     out · g · (g − 1)/g   (out is the scattered piece)
    all-to-all         out · (g − 1)/g
    collective-permute out                   (one send a rank and round)

The rules that say which collectives run:

  * scans: every round the trace's scans ran (``schedule.collect_stats``:
    the MoE dispatch offsets, the context-parallel carries, forward and
    backward) is one collective-permute of that round's bytes a rank;
  * FSDP: every parameter leaf sharded over the axes of its "embed" dim
    is all-gathered once for each use (the forward; in a train step also
    the recompute of the checkpointed repeats, for the block leaves
    under remat), and its gradient reduce-scattered once in a train
    step;
  * TP: the output of each constrained projection whose weight is
    sharded on its contracted dim (over axes other than the FSDP axes)
    is all-reduced once a call (forward and recompute), and once more
    in the backward of a forward call;
  * MoE: the dispatch buffers go through an all-to-all over "model"
    there and back (a train step adds both again in the backward);
    under token-split dispatch the outputs and kept flags are
    all-gathered over "model";
  * fsdp_sp attention: k and v are all-gathered over the sequence axis
    (reduce-scattered again in the backward);
  * weight-stationary decode groups: two all-reduces of activations
    over the FSDP axes (the gate and up products together, then the
    output) take the place of the expert weights' all-gather.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.sharding import rules as rules_lib

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
HARDWARE = "NVIDIA H100 SXM 80GB"
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s of HBM3
LINK_BW = 450e9  # bytes/s of NVLink, each way (900 GB/s all to all)
HBM_BYTES = 80e9  # bytes of HBM a card


def hardware() -> dict:
    """The constants a cell was priced under."""
    return {"name": HARDWARE, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
            "link_bw": LINK_BW, "hbm_bytes": HBM_BYTES,
            "source": "NVIDIA H100 SXM data sheet: bf16 dense, HBM3, "
                      "NVLink 4 each way"}


@dataclasses.dataclass
class CollectiveStats:
    op_counts: dict
    op_bytes: dict  # wire bytes per op kind

    @property
    def total_bytes(self) -> float:
        return sum(self.op_bytes.values())

    @property
    def total_count(self) -> int:
        return sum(self.op_counts.values())


def wire_bytes(op: str, out_bytes: float, g: int) -> float:
    """Ring wire bytes a rank sends for one ``op`` over g ranks."""
    frac = (g - 1) / g if g > 1 else 1.0
    if op == "all-reduce":
        return 2.0 * out_bytes * frac
    if op == "reduce-scatter":
        return out_bytes * g * frac
    if op in ("all-gather", "all-to-all"):
        return out_bytes * frac
    if op == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective {op!r}")


class _Tally:
    def __init__(self):
        self.counts: dict = {}
        self.bytes: dict = {}

    def add(self, op: str, out_bytes: float, g: int, n: int = 1):
        if n <= 0 or (g <= 1 and op != "collective-permute"):
            return
        self.counts[op] = self.counts.get(op, 0) + n
        self.bytes[op] = self.bytes.get(op, 0.0) \
            + n * wire_bytes(op, out_bytes, g)

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.counts), dict(self.bytes))


# constrained projection sites -> (weight leaves that may serve it, the
# logical axis of the weight's contracted dim)
PROJECTIONS = {
    "attn.wq": (("wq",), "embed"), "attn.wk": (("wk",), "embed"),
    "attn.wv": (("wv",), "embed"), "attn.wo": (("wo",), "heads"),
    "ffn.w_gate": (("w_gate", "shared_gate"), "embed"),
    "ffn.w_up": (("w_up", "shared_up"), "embed"),
    "ffn.w_down": (("w_down", "shared_down"), "mlp"),
    "rwkv.wr": (("wr",), "embed"), "rwkv.wk": (("wk",), "embed"),
    "rwkv.wv": (("wv",), "embed"), "rwkv.wg": (("wg",), "embed"),
    "rwkv.wo": (("wo",), "heads"), "rwkv.cm_wk": (("cm_wk",), "embed"),
    "mamba.in_proj": (("in_proj",), "embed"),
    "mamba.out_proj": (("out_proj",), "d_inner"),
}
EXPERT_LEAVES = ("moe_gate", "moe_up", "moe_down")


def _group(entry, mesh) -> int:
    return math.prod(mesh.shape[a] for a in rules_lib.entry_axes(entry))


def _fsdp_entry(axes, spec):
    """The spec entry of a leaf's "embed" dim (None where it has none)."""
    for name, entry in zip(axes, spec):
        if name == "embed":
            return entry
    return None


def _leaf_spec(block_shardings, names):
    for b in block_shardings:
        for n in names:
            if n in b:
                return b[n].spec
    return None


def collectives_of(cfg, mesh, *, shardings, logical, abstract,
                   constraints, n_forward: int, scan_stats,
                   train: bool) -> CollectiveStats:
    """The collectives a sharded run of the traced step issues on one
    rank, under the rules of the module docstring.

    ``shardings``, ``logical`` and ``abstract`` are the parameter trees
    (``Sharding``\\ s, logical axes, meta tensors); ``constraints`` the
    trace's ``(site, local shape, spec)`` records, the first
    ``n_forward`` from the forward (the rest from the recompute in the
    backward); ``scan_stats`` the trace's ``CollectiveStats`` of the
    scans."""
    t = _Tally()
    # scans: one collective-permute a round
    rounds = scan_stats.bytes_per_round
    if rounds:
        t.counts["collective-permute"] = len(rounds)
        t.bytes["collective-permute"] = float(sum(rounds))

    notes = [c[0] for c in constraints]
    ws = any(s.startswith("moe.ws") for s in notes)
    # FSDP: gathers of each use, reduce-scatter of each gradient
    for part in ("top", "blocks"):
        sh_tree, ax_tree, ab_tree = (shardings[part], logical[part],
                                     abstract[part])
        items = ([(sh_tree, ax_tree, ab_tree)] if part == "top"
                 else list(zip(sh_tree, ax_tree, ab_tree)))
        for sh, ax, ab in items:
            for name, s in sh.items():
                entry = _fsdp_entry(ax[name], s.spec)
                g = _group(entry, mesh)
                if g <= 1 or (ws and name in EXPERT_LEAVES):
                    continue
                local = math.prod(s.shard_shape(tuple(ab[name].shape))) \
                    * ab[name].element_size()
                uses = 1 + (1 if train and part == "blocks" and cfg.remat
                            else 0)
                t.add("all-gather", local * g, g, uses)
                if train:
                    t.add("reduce-scatter", local, g)

    # activations: TP all-reduces, the fsdp_sp KV gather, MoE
    rules = rules_lib.rules_for(cfg)
    seq_axes = rules.mesh_axes(("seq",), mesh)[0]
    for i, (site, shape, spec, size) in enumerate(constraints):
        fwd = i < n_forward
        nbytes = math.prod(shape) * size
        bwd = 1 if (train and fwd) else 0
        if site in PROJECTIONS:
            leaves, contracted = PROJECTIONS[site]
            wspec = _leaf_spec(shardings["blocks"], leaves)
            if contracted != "embed" and wspec is not None:
                g = _group(wspec[1], mesh)
                t.add("all-reduce", nbytes, g, 1 + bwd)
            if site in ("attn.wk", "attn.wv") and seq_axes \
                    and spec[1] is None:
                g = _group(seq_axes, mesh)
                t.add("all-gather", nbytes, g)
                t.add("reduce-scatter", nbytes / g, g, bwd)
        elif site == "moe.dispatch":
            g = _group(spec[0], mesh)
            t.add("all-to-all", nbytes, g, 2 * (1 + bwd))
        elif site == "moe.token_split":
            g = _group(spec[0], mesh)
            t.add("all-gather", nbytes, g, 1)
        elif site.startswith("moe.ws"):
            g = _group(spec[0], mesh)
            t.add("all-reduce", nbytes, g, 1)
    return t.stats()


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    bytes_hbm: float  # per device
    collective: CollectiveStats
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float  # 6·N_active·tokens (whole step, all devices)
    n_devices: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """MFU if the step ran exactly at the dominant roofline term."""
        denom = self.bound_s * self.n_devices * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0


def analyze(flops: float, bytes_hbm: float, coll: CollectiveStats, *,
            model_flops: float, n_devices: int) -> Roofline:
    """The roofline of one device's FLOPs, bytes and collectives."""
    return Roofline(
        flops=flops, bytes_hbm=bytes_hbm, collective=coll,
        compute_s=flops / PEAK_FLOPS, memory_s=bytes_hbm / HBM_BW,
        collective_s=coll.total_bytes / LINK_BW,
        model_flops=model_flops, n_devices=n_devices)
