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
(``_swiglu_experts_ws``) is a sharding of the same function (partial
products over FSDP slices and a psum), so on one card it is
``_swiglu_experts``; only its grouping effect is kept, and the dry run
prices its collectives from what ``moe_ffn`` notes
(``sharding.ctx.note``: one rank's dispatch buffer, the token-split
gathers, the weight-stationary psums).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.scan_api import ScanSpec, scan_with_total
from repro_torch.core.schedule import SPMDExecutor, StackedExecutor
from repro_torch.kernels.moe_routing import moe_routing
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import params as PD
from repro_torch.models.common import rmsnorm, swiglu
from repro_torch.sharding import ctx as sharding_ctx
from repro_torch.sharding.rules import P


def dispatch_slots(cfg, top_e: torch.Tensor, *, spec: ScanSpec | None = None,
                   executor=None):
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
    """
    rows, n0, k = top_e.shape
    procs = isinstance(executor, SPMDExecutor)
    if procs and rows != executor.ranks_per_proc:
        raise ValueError(f"top_e's leading axis of {rows} is not the "
                         f"process's block of {executor.ranks_per_proc} "
                         f"ranks")
    p = executor.p if procs else rows
    e_pad = PD.experts_padded(cfg)
    positions, counts = moe_routing(top_e, num_experts=e_pad)
    if p > 1:
        spec = spec if spec is not None else cfg.scan_spec
        if executor is None:
            executor = StackedExecutor(top_e.device)
        lone = procs and not executor.lead  # one rank: no block axis
        offsets, totals = scan_with_total(
            counts[0] if lone else counts,
            spec.over(spec.axis_name, kind="exclusive", monoid="add"),
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
    n_fsdp = 1
    for a in bt_w:
        n_fsdp *= mesh.shape[a]
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


def _router(cfg, toks, router):
    """Masked router probabilities (..., e_pad) fp32."""
    e_pad = PD.experts_padded(cfg)
    logits = (toks @ router).float()
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


def moe_ffn(cfg, p, x, mesh, *, executor=None):
    """MoE feed-forward on normed input x: (B, S, d) -> (y, aux), aux
    the fp32 pair [load-balance, dropped fraction].

    The token groups of the mesh's ranks are stacked: (n_groups, n0,
    d).  One routing launch gives every group's local positions, one
    ``scan_with_total`` over the groups (when there is more than one,
    on ``executor``) their offsets and totals; each group fills its
    capacity-padded send buffer, the stacked all-to-all brings every
    expert its rows, the expert SwiGLU runs once over all of them, and
    the reverse trip and the gated combine give each token its y."""
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
    probs = _router(cfg, toks, p["router"])
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
    out = _swiglu_experts(recv.reshape(e_pad, n_data * mg * cap, d),
                          p["moe_gate"], p["moe_up"], p["moe_down"])
    # reverse trip
    back = out.reshape(e_pad, n_data, mg, cap, d).permute(
        1, 2, 0, 3, 4).reshape(G, rows, d)

    # combine: gather own slots, weight by (renormalized) gate probs
    got = back.gather(1, slot.clamp(max=rows - 1).long()[..., None].expand(
        G, n0 * k, d))
    got = torch.where(keep[..., None], got,
                      torch.zeros((), dtype=got.dtype, device=got.device))
    weighted = got.reshape(G, n0, k, d) * top_p[..., None].to(x.dtype)
    y = weighted.sum(dim=2)  # (G, n0, d)
    kept = keep.reshape(G, n0, k).float()
    if gr.seq_sp:
        y = y.reshape(n_data, mg, B // n_data, S // mg, d).transpose(1, 2)
    y = y.reshape(B, S, d)

    # metrics: the fused scan's totals are the exact global (token,
    # slot) counts per expert; the groups hold every token once, so
    # their router probabilities give the mean
    frac = totals[0].float() / (B * S)
    pmean = probs.reshape(-1, e_pad).mean(dim=0)
    e_real = cfg.n_experts
    lb = e_real * torch.sum(frac[:e_real] * pmean[:e_real]) / k
    dropped = 1.0 - kept.mean()
    return y, torch.stack([lb, dropped])


def moe_block(cfg, p, x, mesh, *, executor=None):
    """Pre-norm MoE FFN sub-block with optional shared experts."""
    xn = rmsnorm(x, p["norm2"], cfg.norm_eps)
    y, aux = moe_ffn(cfg, p, xn, mesh, executor=executor)
    if cfg.n_shared_experts:
        y = y + swiglu(xn, p["shared_gate"], p["shared_up"],
                       p["shared_down"])
    return x + y, aux
