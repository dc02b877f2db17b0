"""Expert-parallel MoE layer with exscan-based global dispatch
accounting, on one card, from the JAX package's ``models/moe.py``.

Each token-holding rank routes its tokens to experts; a token is kept
iff its GLOBAL position within its expert (across all ranks) is under
the expert's global capacity.  That global position is

    global_pos = exscan(per-rank expert counts)[expert] + local_pos

and the capacity accounting also needs the global per-expert totals, so
offsets and totals ride ONE fused "scan_total" schedule
(``scan_api.scan_with_total``).  ``dispatch_slots`` is that accounting
as a function of its own, with the p ranks stacked on a leading axis:
the local positions and counts of every rank come from one launch of
the routing kernel.

``moe_ffn`` is the whole layer around it.  The reference runs it under
``shard_map`` on a (data, model) mesh; here the model's ``mesh`` (a
``launch.mesh.HostMesh``) only says how many ranks there are, and the
ranks' token groups sit on the leading axis of one card's tensors.  The
grouping decisions (``moe_groups``: seq_sp, token_split, the
weight-stationary replication, the small-batch fallback) are the
reference's, taken from (B, S, mesh, cfg), because they fix the number
of groups, hence the capacity, hence which tokens drop.  The
all-to-all over "model" becomes a permutation of the stacked send
buffers: expert e's rows from every source rank of a data shard side
by side.  The reference's weight-stationary expert FFN
(``_swiglu_experts_ws``: partial products over the FSDP slices of d and
a psum) is computed as the processes compute it, slice by slice, the
partials summed in data order (:func:`_ws_experts`), so the one-card
layer has the processes' bits; the dry run prices its collectives from
what ``moe_ffn`` notes (``sharding.ctx.note``: one rank's dispatch
buffer, the token-split gathers, the weight-stationary psums).
"""

from __future__ import annotations

import dataclasses
import typing

import torch
import torch.nn.functional as F

from repro_torch.core.scan_api import (ScanPlan, ScanSpec, plan,
                                      scan_with_total)
from repro_torch.core.schedule import (SPMDExecutor, StackedExecutor,
                                       sum_in_order)
from repro_torch.kernels.moe_routing import moe_routing
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import params as PD
from repro_torch.models.common import rmsnorm
from repro_torch.models.shards import WHOLE, WHOLE_D, Shards
from repro_torch.sharding import ctx as sharding_ctx
from repro_torch.sharding.rules import P


def dispatch_slots(cfg, top_e: torch.Tensor, *, spec: ScanSpec | None = None,
                   executor=None, axis: str | None = None):
    """The dispatch accounting of p ranks' routing choices.

    top_e: (p, n0, k) int32, each rank's router choices.  Returns
    (positions (p, n0, k), offsets (p, e_pad), totals (p, e_pad),
    keep (p, n0·k) bool, slot (p, n0·k) int32): each entry's position
    in its rank's expert buffer, the exclusive scan of the per-rank
    expert counts across ranks and their sum, whether the entry fits
    the global capacity, and its row in the rank's (e_pad·cap, d) send
    buffer (e_pad·cap where dropped).  With an ``SPMDExecutor`` top_e
    is this process's block (P, n0, k) of the executor's p ranks, the
    outputs are the block's, and the offsets and totals come from one
    ``scan_with_total`` across the processes, as the JAX package takes
    them under ``shard_map``; the global capacity is the p ranks'.
    ``axis`` names the axis of the executor's mesh the groups span where
    they do not span all of it (the other axes' processes hold the same
    groups and run the same scan, as the reference scans over the data
    axes alone where the model ranks replicate the dispatch); the
    capacity is then the axis's groups'.
    """
    rows, n0, k = top_e.shape
    procs = isinstance(executor, SPMDExecutor)
    if procs and rows != executor.ranks_per_proc:
        raise ValueError(f"top_e's leading axis of {rows} is not the "
                         f"process's block of {executor.ranks_per_proc} "
                         f"ranks")
    if axis is not None and not procs:
        raise ValueError("a dispatch over one mesh axis needs an "
                         "SPMDExecutor")
    p = rows if not procs else executor.p if axis is None \
        else executor.axis_sizes((axis,))[0]
    e_pad = PD.experts_padded(cfg)
    positions, counts = moe_routing(top_e, num_experts=e_pad)
    if p > 1:
        spec = spec if spec is not None else cfg.scan_spec
        if executor is None:
            executor = StackedExecutor(top_e.device)
        lone = procs and not executor.lead  # one rank: no block axis
        offsets, totals = scan_with_total(
            counts[0] if lone else counts,
            spec.over(spec.axis_name if axis is None else axis,
                      kind="exclusive", monoid="add"),
            executor=executor)
        if lone:
            offsets, totals = offsets[None], totals[None]
    else:
        offsets, totals = torch.zeros_like(counts), counts
    cap = capacity(cfg, n0, k)
    cap_global = cap * p
    flat_e = top_e.reshape(rows, n0 * k)
    flat_pos = positions.reshape(rows, n0 * k)
    global_pos = offsets.gather(1, flat_e.long()) + flat_pos
    keep = (flat_pos < cap) & (global_pos < cap_global)
    slot = torch.where(keep, flat_e * cap + flat_pos,
                       torch.full_like(flat_e, e_pad * cap))
    return positions, offsets, totals, keep, slot


def capacity(cfg, n0: int, k: int) -> int:
    """Rows per (rank, expert) in the send buffer for n0 tokens of k
    slots each."""
    return max(8, int(cfg.capacity_factor * n0 * k / PD.experts_padded(cfg)))


@dataclasses.dataclass(frozen=True)
class Groups:
    """How the reference splits (B, S) tokens over the ranks of a mesh.

    n_data: token-holding data shards (1 when tokens are replicated);
    m_groups: groups per data shard (tp under seq_sp or token_split,
    else 1: the model ranks hold the same tokens); n0: tokens a group.
    """

    seq_sp: bool
    ws: bool
    token_split: bool
    n_data: int
    m_groups: int
    n0: int

    @property
    def n_groups(self) -> int:
        return self.n_data * self.m_groups


def moe_groups(cfg, B: int, S: int, mesh) -> Groups:
    """The reference's grouping decisions for a (B, S) call on ``mesh``
    (``src/repro/models/moe.py`` ``moe_ffn``, lines 98-136 and 142-158)."""
    k = cfg.top_k
    d = cfg.d_model
    tp = mesh.shape["model"]
    bt = batch_axes(mesh)
    n_data = 1
    for a in bt:
        n_data *= mesh.shape[a]
    bt_w = bt  # weight FSDP axes — independent of token sharding
    if n_data > 1 and B % n_data != 0:
        # batch too small to shard: tokens replicated over the data axes
        bt, n_data = (), 1
    n0_full = (B // max(n_data, 1)) * S
    seq_sp = (cfg.sharding_strategy == "fsdp_sp" and S % tp == 0
              and S >= tp)
    n_fsdp = fsdp_size(mesh)
    ws = (bool(bt_w) and d % n_fsdp == 0 and B * S * k <= 4096
          and cfg.moe_weight_stationary)
    if ws:
        # weight-stationary: the (tiny) token set is replicated over the
        # data axes
        bt, n_data, n0_full = (), 1, B * S
    token_split = (not seq_sp) and n0_full % tp == 0 and n0_full >= tp
    m_groups = tp if (seq_sp or token_split) else 1
    return Groups(seq_sp=seq_sp, ws=ws, token_split=token_split,
                  n_data=n_data, m_groups=m_groups,
                  n0=n0_full // m_groups)


def _swiglu_experts(t, gate, up, down):
    """t: (E, n, d); weights: (E, d, f) / (E, f, d)."""
    g = F.silu(torch.bmm(t, gate))
    u = torch.bmm(t, up)
    return torch.bmm(g * u, down)


def fsdp_size(mesh) -> int:
    """The data ranks the weights' "embed" dim splits over."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _ws_partials(t, gate, up, i: int):
    """Slice i of d's (g, u) partial products, stacked (2, E, n, f): t
    (E, n, d) full-d tokens against gate and up (E, d_l, f), d_l =
    their d-slice."""
    d_l = gate.shape[1]
    t_l = t[..., i * d_l:(i + 1) * d_l].contiguous()
    return torch.stack([torch.bmm(t_l, gate), torch.bmm(t_l, up)])


def _ws_experts(t, gate, up, down, n: int):
    """The reference's weight-stationary expert FFN
    (``_swiglu_experts_ws``) on one program holding all n data slices of
    d: t (E, rows, d); weights whole, (E, d, f) / (E, f, d).  Each
    slice's (g, u) partials, summed in data order in fp32 and cast once
    (``sum_in_order``: the processes' ``all_reduce``), then silu(g)·u
    against each slice of down, the n (E, rows, d/n) outputs joined
    along d.  Each weight slice is copied out contiguous, as a process
    holds it, so each product has a process's operands."""
    d_l = t.shape[-1] // n
    cut = [slice(i * d_l, (i + 1) * d_l) for i in range(n)]
    gu = sum_in_order(torch.stack([_ws_partials(
        t, gate[:, c].contiguous(), up[:, c].contiguous(), i)
        for i, c in enumerate(cut)]))
    h = F.silu(gu[0]) * gu[1]
    return torch.cat([torch.bmm(h, down[..., c].contiguous()) for c in cut],
                     dim=-1)


def _router(cfg, toks, router, dsl=WHOLE_D):
    """Masked router probabilities (..., e_pad) fp32; under decode_ws
    (``dsl``) from the d-slices' partials, summed over "data"."""
    e_pad = PD.experts_padded(cfg)
    logits = dsl.dots([(toks, router)])[0].float()
    emask = torch.arange(e_pad, device=toks.device) < cfg.n_experts
    return torch.softmax(logits.masked_fill(~emask, float("-inf")), dim=-1)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32).contiguous()


def _note_collectives(gr: Groups, mesh, e_pad: int, cap: int, k: int,
                      d: int, ffe: int, itemsize: int) -> None:
    """What the reference's shard_map moves on one rank: the (e_pad·cap,
    d) dispatch buffer through an all-to-all over "model"; under
    token-split dispatch the (tp·n0, d) outputs and (tp·n0, k) fp32 kept
    flags gathered over "model"; in a weight-stationary group the
    (e_local, tp·cap, f) gate and up products, then the (e_local,
    tp·cap, d) output, summed over the FSDP axes."""
    tp = mesh.shape["model"]
    model = P(("model",))
    sharding_ctx.note("moe.dispatch", (e_pad * cap, d), model, itemsize)
    if gr.token_split:
        sharding_ctx.note("moe.token_split", (tp * gr.n0, d), model,
                          itemsize)
        sharding_ctx.note("moe.token_split", (tp * gr.n0, k), model, 4)
    if gr.ws:
        fsdp = P(batch_axes(mesh))
        e_local = e_pad // tp
        sharding_ctx.note("moe.ws_gate_up", (2, e_local, tp * cap, ffe),
                          fsdp, itemsize)
        sharding_ctx.note("moe.ws_out", (e_local, tp * cap, d), fsdp,
                          itemsize)


def moe_ffn(cfg, p, x, mesh, *, executor=None, batch: int | None = None,
            dsl=WHOLE_D):
    """MoE feed-forward on normed input x: (B, S, d) -> (y, aux), aux
    the fp32 pair [load-balance, dropped fraction].

    The token groups of the mesh's ranks are stacked: (n_groups, n0,
    d).  One routing launch gives every group's local positions, one
    ``scan_with_total`` over the groups (when there is more than one,
    on ``executor``) their offsets and totals; each group fills its
    capacity-padded send buffer, the stacked all-to-all brings every
    expert its rows, the expert SwiGLU runs once over all of them, and
    the reverse trip and the gated combine give each token its y.

    With an ``SPMDExecutor`` over the mesh, process k is mesh rank (i,
    j) = divmod(k, tp) and runs the reference's ``local_moe`` on its own
    tokens and experts (:func:`_moe_procs`): ``x`` holds its rows of
    the global ``batch`` (:func:`held_rows`; by default x is data shard
    i), ``p``'s expert leaves its e_pad/tp experts
    (``params.shard_params``), and y covers its rows.

    Under decode_ws (``dsl``, ``models.shards.DSlices`` of n > 1 data
    slices) x holds the activations' d as ``dsl`` says, every row: the
    router's partials from the d-slices are summed over "data" (the
    stacked path sums its slices in the same order); in a
    weight-stationary call each process dispatches its d-slice of the
    tokens and the expert FFN multiplies it, y written in that slice
    (on one program each slice combined apart, as a process combines
    it); otherwise the tokens are joined along d first and y cut back
    (:func:`_moe_procs`)."""
    return _moe_ffn(cfg, p, x, mesh, executor, batch, dsl)[:2]


def _moe_ffn(cfg, p, x, mesh, executor, batch, dsl=WHOLE_D):
    """``moe_ffn`` and the kept flags (B, S, k) fp32 of x's tokens."""
    if isinstance(executor, SPMDExecutor):
        return _moe_procs(cfg, p, x, mesh, executor, batch, dsl)
    e_pad = PD.experts_padded(cfg)
    k = cfg.top_k
    B, S, d = x.shape
    gr = moe_groups(cfg, B, S, mesh)
    G, n0, n_data, mg = gr.n_groups, gr.n0, gr.n_data, gr.m_groups

    xd = x.reshape(n_data, B // n_data, S, d)
    if gr.seq_sp:  # rank m holds sequence shard m of its batch rows
        toks = xd.reshape(n_data, B // n_data, mg, S // mg, d).transpose(
            1, 2).reshape(G, n0, d)
    else:  # token_split: contiguous slices of the shard's tokens
        toks = xd.reshape(G, n0, d)
    _note_collectives(gr, mesh, e_pad, capacity(cfg, n0, k), k, d,
                      cfg.moe_d_ff, x.element_size())
    probs = _router(cfg, toks, p["router"], dsl)
    top_p, top_e = _top_k(probs, k)  # (G, n0, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    _, _, totals, keep, slot = dispatch_slots(cfg, top_e, executor=executor)
    cap = capacity(cfg, n0, k)
    rows = e_pad * cap

    # scatter into the (rows, d) send buffers; dropped entries land in
    # one spare row, sliced off (the reference's mode="drop")
    toks_rep = toks.repeat_interleave(k, dim=1)  # (G, n0*k, d)
    buf = torch.zeros((G, rows + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot.long()[..., None].expand(G, n0 * k, d), toks_rep)
    buf = buf[:, :rows]

    # dispatch: expert e receives rows [e·cap, (e+1)·cap) of every
    # source group of its data shard
    recv = buf.reshape(n_data, mg, e_pad, cap, d).permute(2, 0, 1, 3, 4)
    recv = recv.reshape(e_pad, n_data * mg * cap, d)
    n_fsdp = fsdp_size(mesh)
    if gr.ws and n_fsdp > 1:  # the reference's d-sliced partials
        out = _ws_experts(recv, p["moe_gate"], p["moe_up"], p["moe_down"],
                          n_fsdp)
    else:
        out = _swiglu_experts(recv, p["moe_gate"], p["moe_up"],
                              p["moe_down"])
    # reverse trip
    back = out.reshape(e_pad, n_data, mg, cap, d).permute(
        1, 2, 0, 3, 4).reshape(G, rows, d)

    # combine: gather own slots, weight by (renormalized) gate probs;
    # under decode_ws's weight-stationary call each data slice of d
    # apart, as its process combines it
    def combine(back):
        w = back.shape[-1]
        got = back.gather(1, slot.clamp(max=rows - 1).long()[..., None]
                          .expand(G, n0 * k, w))
        got = torch.where(keep[..., None], got,
                          torch.zeros((), dtype=got.dtype, device=got.device))
        weighted = got.reshape(G, n0, k, w) * top_p[..., None].to(x.dtype)
        return weighted.sum(dim=2)  # (G, n0, w)

    if gr.ws and dsl.n > 1:
        w = d // dsl.n
        y = torch.cat([combine(back[..., i * w:(i + 1) * w].contiguous())
                       for i in dsl.ids], dim=-1)
    else:
        y = combine(back)
    kept = keep.reshape(G, n0, k).float()
    if gr.seq_sp:
        y = y.reshape(n_data, mg, B // n_data, S // mg, d).transpose(1, 2)
    y = y.reshape(B, S, d)

    # metrics: the fused scan's totals are the exact global (token,
    # slot) counts per expert; the groups hold every token once, so
    # their router probabilities give the mean
    aux = _aux(cfg, totals[0], probs, kept, B * S)
    if gr.seq_sp:
        kept = kept.reshape(n_data, mg, B // n_data, S // mg, k).transpose(
            1, 2)
    return y, aux, kept.reshape(B, S, k)


# ---------------------------------------------------------------------------
# the layer over ranks held by processes
# ---------------------------------------------------------------------------

QUEUE_ITEM = PD.QUEUE_ITEM


def held_rows(B: int, mesh, rank: int) -> slice:
    """The rows of a global batch of B that process ``rank`` of a (data,
    model) grid holds: data shard i = rank // tp's B/n_data rows where
    the batch splits over the data ranks, every row where it does not
    (n_data = 1, or B not a multiple of it: the reference's small-batch
    fallback replicates the tokens)."""
    n_data, tp = mesh.shape["data"], mesh.shape["model"]
    if n_data > 1 and B % n_data == 0:
        i = rank // tp
        return slice(i * (B // n_data), (i + 1) * (B // n_data))
    return slice(0, B)


def check_layout(cfg, mesh, executor) -> None:
    """Raise, before any message, where the model cannot run over
    ``executor``'s processes as laid out: a mesh other than (data,
    model), a block of more than one rank a process, an executor whose
    mesh is not the model's, tp not dividing the padded experts, a dense
    layer the rule table splits over "model" that tp cannot split whole
    (``params.plan_split``: the heads, the kv heads, d_ff, the shared
    experts' width, the padded vocabulary)."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"the MoE layer over processes takes a (data, "
                         f"model) mesh, got {tuple(mesh.axis_names)} "
                         f"({QUEUE_ITEM})")
    D, tp = mesh.shape["data"], mesh.shape["model"]
    e_pad = PD.experts_padded(cfg)
    if e_pad % tp:
        raise ValueError(f"tp = {tp} model processes do not divide the "
                         f"{e_pad} padded experts ({QUEUE_ITEM})")
    if executor.ranks_per_proc != 1:
        raise ValueError(f"the MoE layer over processes holds one rank a "
                         f"process, not {executor.ranks_per_proc} "
                         f"({QUEUE_ITEM})")
    if executor.mesh != (("data", D), ("model", tp)):
        raise ValueError(f"the executor's mesh {executor.mesh} over "
                         f"{executor.p} ranks is not the model's (data "
                         f"{D}, model {tp})")
    PD.plan_split(cfg, mesh)


def expert_range(cfg, mesh, rank: int) -> tuple[int, int]:
    """[lo, hi): the padded experts that model rank j = rank % tp
    holds."""
    e_local = PD.experts_padded(cfg) // mesh.shape["model"]
    j = rank % mesh.shape["model"]
    return j * e_local, (j + 1) * e_local


class Dispatch(typing.NamedTuple):
    """The dispatch scan of a MoE layer call over processes."""

    axis: str | None | bool  # the processes whose groups differ
    spec: ScanSpec | None  # its scan_total of the (e_pad,) int32 counts
    plan: ScanPlan | None


def dispatch_plan(cfg, B: int, S: int, mesh) -> Dispatch:
    """The dispatch scan of one MoE layer call at (B, S) with the ranks
    of ``mesh`` held by processes, one a process.  ``axis`` names the
    processes whose token groups differ, as the axis argument of
    ``dispatch_slots`` and the executor's collectives: None for every
    process (data-major), "data" or "model" for that axis alone (the
    other axis's processes run the same scan), False where one group is
    all there is and nothing is scanned."""
    gr = moe_groups(cfg, B, S, mesh)
    n = mesh.shape["data"] * mesh.shape["model"]
    if gr.n_groups == 1:
        return Dispatch(False, None, None)
    axis = None if gr.n_groups == n else \
        "data" if gr.m_groups == 1 else "model"
    p = n if axis is None else mesh.shape[axis]
    spec = cfg.scan_spec.over(axis, kind="scan_total", monoid="add")
    return Dispatch(axis, spec,
                    plan(spec, p, nbytes=4 * PD.experts_padded(cfg)))


def _moe_procs(cfg, p, x, mesh, ex, batch, dsl=WHOLE_D):
    """The reference's ``local_moe`` on process k = mesh rank (i, j).

    Its tokens: x's rows (:func:`held_rows`), all-gathered over "data"
    first where the weight-stationary grouping replicates a batch the
    processes split, then its group's slice where the model ranks split
    the tokens.  One routing launch on its (1, n0, k) choices, the
    offsets and totals from ``dispatch_slots`` over the processes whose
    groups differ (:func:`dispatch_plan`), the scatter into the
    (e_pad·cap, d) send buffer, ``all_to_all`` over data shard i's
    "model" processes to their e_pad/tp experts, laid out (e_local,
    tp·cap, d), and the same call back.  Under token split y is
    all-gathered over "model".  The metrics need every group's router
    probabilities and kept flags: one all-gather of both over the
    processes whose groups differ gives them in the stacked order, so
    aux is the stacked path's, bit for bit, on every process.

    Where the grouping is weight-stationary and d splits over n_data >
    1 data processes, the experts stay sliced (``params.shard_params``:
    gate and up (e_local, d/n_data, f), down (e_local, f, d/n_data)):
    process (i, j) multiplies its slice i of the tokens' d, one
    ``all_reduce`` over "data" sums the stacked (g, u) partials (the
    reference psums them apart: the same elementwise sums), and after
    silu(g)·u against its slice of down one ``all_gather`` over "data"
    joins the (e_local, tp·cap, d/n_data) outputs along d (the reference
    zero-pads and psums: exact either way; the dry run prices that
    ``moe.ws_out`` all-reduce).  Otherwise the experts come whole in d
    (the model gathers them with the layer's leaves).

    Under decode_ws (``dsl`` of n_data > 1 slices) x is every row's
    d-slice i (B, S, d/n_data) and so is y.  The router's partials over
    every token are summed over "data" (counted as "ws_reduce").  A
    weight-stationary call dispatches the d-slices themselves: the
    tokens need no gather and the outputs none, only the (g, u)
    partials' all-reduce (as "ws_reduce").  Any other call joins the
    tokens' d over "data" (one all-gather, as "ws_gather"), runs the
    above on data shard i's rows with its experts gathered whole by the
    model, and gathers y's rows back over "data" (as "ws_gather") to
    keep its slice of d.

    Under autograd (training) every collective has its backward
    (``SPMDExecutor``): the all-to-alls their transposes; the token
    split's slice of the data shard's tokens and router probabilities
    (``own_rows``) the all-gather over "model" of the slices'
    gradients, and the all-gather of y the process's own rows, since the
    model processes compute alike from both; the metrics' all-gather
    its own rows too, every process computing the same metrics.  Where
    the weight-stationary grouping replicates the tokens over "data",
    each data process holds the gradient of its own rows only: the
    tokens' all-gather and the outputs' are reduce-scattered back, the
    partials' all-reduce all-reduces the gradient, and the metrics'
    gradient, which every data process would otherwise count whole, is
    taken 1/n_data on each.  The dispatch offsets are integers and take
    none.  The replicated dispatch (fewer tokens than model processes)
    computes every expert's rows tp times and does not train."""
    check_layout(cfg, mesh, ex)
    e_pad = PD.experts_padded(cfg)
    k = cfg.top_k
    D, tp = mesh.shape["data"], mesh.shape["model"]
    sliced = dsl.n > 1
    B_l, S, d = x.shape
    B = B_l * (1 if sliced else D) if batch is None else int(batch)
    rows = held_rows(B, mesh, ex.rank)
    if (B if sliced else rows.stop - rows.start) != B_l:
        raise ValueError(f"x holds {B_l} rows; process {ex.rank} holds "
                         f"{B if sliced else rows.stop - rows.start} of a "
                         f"batch of {B}")
    gr = moe_groups(cfg, B, S, mesh)
    if gr.seq_sp:
        raise NotImplementedError(f"the sequence-split MoE dispatch "
                                  f"(fsdp_sp) over processes is "
                                  f"{QUEUE_ITEM}")
    e_local = e_pad // tp
    n_fsdp = fsdp_size(mesh) if gr.ws else 1
    want = (e_local, cfg.d_model // n_fsdp)
    if tuple(p["moe_gate"].shape[:2]) != want:
        raise ValueError(f"the process holds experts of "
                         f"{tuple(p['moe_gate'].shape)}; at this call its "
                         f"share is (e_local, d_l) = {want} of {e_pad} "
                         f"experts (params.shard_params)")
    i, j = divmod(ex.rank, tp)
    split = (B_l < B) or (sliced and B % D == 0 and D > 1)
    trains = torch.is_grad_enabled() and (
        x.requires_grad or p["router"].requires_grad)
    if trains and tp > 1 and not gr.token_split:
        raise NotImplementedError(f"the replicated MoE dispatch ({B * S} "
                                  f"tokens, fewer than the {tp} model "
                                  f"processes' groups) under autograd is "
                                  f"{QUEUE_ITEM}")
    xs = x
    if sliced:
        # the router over every token's d-slice, summed over "data"
        probs = _router(cfg, x.reshape(-1, d), p["router"], dsl)
        if not gr.ws:  # d joined, then data shard i's rows
            xs = torch.cat(ex.all_gather(x, "data", kind="ws_gather")
                           .unbind(0), dim=-1)
            d = xs.shape[-1]
            if split:
                xs = xs[rows]
                probs = probs.reshape(B, S, e_pad)[rows].reshape(-1, e_pad)
        toks = xs.reshape(-1, d)
    else:
        if gr.ws and split:  # the reference replicates the tokens over data
            xs = ex.all_gather(x, "data", scatter="reduce_scatter").reshape(
                B, S, d)
        # the router over every token held, as the stacked path routes all
        # of its groups in one product, then this group's rows
        toks = xs.reshape(-1, d)
        probs = _router(cfg, toks, p["router"])
    n0 = gr.n0
    if gr.token_split:
        toks, probs = (ex.own_rows(t, "model") for t in (toks, probs))
    axis = dispatch_plan(cfg, B, S, mesh).axis
    top_p, top_e = _top_k(probs, k)  # (n0, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    cap = capacity(cfg, n0, k)
    _note_collectives(gr, mesh, e_pad, cap, k, cfg.d_model, cfg.moe_d_ff,
                      x.element_size())
    if axis is False:
        _, _, totals, keep, slot = dispatch_slots(cfg, top_e[None])
    else:
        _, _, totals, keep, slot = dispatch_slots(cfg, top_e[None],
                                                  executor=ex, axis=axis)
    totals, keep, slot = totals[0], keep[0], slot[0]
    nrows = e_pad * cap

    buf = torch.zeros((nrows + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(0, slot.long()[:, None].expand(n0 * k, d),
                 toks.repeat_interleave(k, dim=0))
    buf = buf[:nrows]
    # dispatch: (tp, e_local·cap, d) through the all-to-all; recv
    # (tp_src, e_local, cap, d) -> (e_local, tp_src·cap, d)
    recv = ex.all_to_all(buf.reshape(tp, e_local * cap, d), "model")
    recv = recv.reshape(tp, e_local, cap, d).transpose(0, 1).reshape(
        e_local, tp * cap, d)
    if n_fsdp > 1 and sliced:  # the d-slice is the tokens' own
        gu = ex.all_reduce(torch.stack([torch.bmm(recv, p["moe_gate"]),
                                        torch.bmm(recv, p["moe_up"])]),
                           "data", kind="ws_reduce")
        out = torch.bmm(F.silu(gu[0]) * gu[1], p["moe_down"])
    elif n_fsdp > 1:  # the reference's _swiglu_experts_ws
        gu = ex.all_reduce(_ws_partials(recv, p["moe_gate"], p["moe_up"], i),
                           "data", backward="all_reduce")
        h = F.silu(gu[0]) * gu[1]
        out = torch.cat(ex.all_gather(torch.bmm(h, p["moe_down"]), "data",
                                      scatter="reduce_scatter").unbind(0),
                        dim=-1)
    else:
        out = _swiglu_experts(recv, p["moe_gate"], p["moe_up"],
                              p["moe_down"])
    # reverse trip
    out = out.reshape(e_local, tp, cap, d).transpose(0, 1).reshape(
        tp, e_local * cap, d)
    back = ex.all_to_all(out, "model").reshape(nrows, d)

    got = back.gather(0, slot.clamp(max=nrows - 1).long()[:, None].expand(
        n0 * k, d))
    got = torch.where(keep[:, None], got,
                      torch.zeros((), dtype=got.dtype, device=got.device))
    y = (got.reshape(n0, k, d) * top_p[..., None].to(x.dtype)).sum(dim=1)
    kept = keep.reshape(n0, k).float()
    # every group's probabilities and kept flags, in the groups' order
    mine = torch.cat([probs, kept], dim=1)
    every = mine[None] if axis is False else ex.all_gather(mine, axis)
    if gr.ws and split and every.requires_grad:
        every = _ScaleGrad.apply(every, 1.0 / D)
    aux = _aux(cfg, totals, every[..., :e_pad].contiguous(),
               every[..., e_pad:].contiguous(), B * S)
    if gr.token_split:
        y = ex.all_gather(y, "model")
        first = i * tp if axis is None else 0  # this data shard's groups
        kept = every[first:first + tp, :, e_pad:]
    y, kept = y.reshape(-1, S, d), kept.reshape(-1, S, k)
    if sliced and not gr.ws:  # every row again, then this slice of d
        if split:
            y = torch.cat(ex.all_gather(y, "data", kind="ws_gather")
                          .unbind(0))
            kept = every[..., e_pad:].reshape(B, S, k)
        y = dsl.chan(y)
    elif gr.ws and split and not sliced:  # back to this process's rows
        y, kept = y[rows], kept[rows]
    return y, aux, kept


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled by ``scale``."""

    @staticmethod
    def forward(ctx, t, scale: float):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _aux(cfg, totals, probs, kept, tokens: int):
    """[load-balance, dropped] from the global per-expert totals and
    every group's router probabilities (G, n0, e_pad) and kept flags
    (G, n0, k), in the stacked path's arithmetic."""
    e_real, k = cfg.n_experts, cfg.top_k
    frac = totals.float() / tokens
    pmean = probs.reshape(-1, probs.shape[-1]).mean(dim=0)
    lb = e_real * torch.sum(frac[:e_real] * pmean[:e_real]) / k
    return torch.stack([lb, 1.0 - kept.mean()])


def moe_block(cfg, p, x, mesh, *, executor=None, batch: int | None = None,
              shards: Shards = WHOLE, rows=None, dsl=WHOLE_D):
    """Pre-norm MoE FFN sub-block with optional shared experts, split
    over the "model" ranks by ``shards`` (``models.shards``) as the
    dense FFN is; ``rows`` (``Model._rows``) runs the shared experts a
    data shard's rows at a time on one card; ``dsl`` as the activations
    hold d (decode_ws)."""
    xn = rmsnorm(x, p["norm2"], cfg.norm_eps, dsl)
    y, aux = moe_ffn(cfg, p, xn, mesh, executor=executor, batch=batch,
                     dsl=dsl)

    if cfg.n_shared_experts:
        def shared(xn, _):
            return shards.swiglu(xn, p, "shared_gate", "shared_up",
                                 "shared_down", dsl)

        y = y + (shared(xn, None) if rows is None else rows(shared, xn))
    return x + y, aux
