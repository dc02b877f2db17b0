"""Context-parallel SSM prefill through the paper's exscan, on one card.

With the sequence split into p shards, each rank scans only its shard;
the carry entering rank r is the composition of ALL earlier ranks'
shard summaries — an exclusive prefix "sum" under the (associative,
costly, non-commutative) state composition of the affine monoid:

    mamba / diagonal SSM:  (A, B) with  h_out = A * h_in + B
    rwkv (matrix state):   (W, S) with  S_out = diag(W) S_in + S

This is the paper's headline scenario: m is one state vector, ⊕ is
costly, and the number of rounds dominates.  By default the p ranks sit
on a leading axis of one card's tensors, so the shards of all ranks are
scanned by one launch and the cross-rank carry runs the planner's
schedule through the stacked executor and the affine round kernels.
With an ``SPMDExecutor`` the tensors are one process's block of P ranks
(p = the executor's world·P), as the JAX package runs these scans under
``shard_map`` with a rank a device: the launches cover the block and
the carry crosses processes.
"""

from __future__ import annotations

import math
import threading

import torch

from repro_torch.core.scan_api import ScanSpec, plan
from repro_torch.core import monoid as monoid_lib
from repro_torch.core.schedule import (SPMDExecutor, StackedExecutor,
                                       on_mesh, stats_of_thread)
from repro_torch.kernels import scan_engine

# Default policy for the shard-summary carry: affine state composition,
# planner-selected algorithm.
CARRY_SPEC = ScanSpec(kind="exclusive", monoid="affine", algorithm="auto")


def _carry_spec(spec: ScanSpec | None, algorithm: str | None) -> ScanSpec:
    """Resolve the (spec, legacy algorithm kwarg) pair onto the rank
    axis."""
    spec = spec if spec is not None else CARRY_SPEC
    if algorithm is not None:  # legacy string path
        spec = spec.over(spec.axis_name, algorithm=algorithm)
    return spec.over(spec.axis_name, kind="exclusive", monoid="affine")


def _ranks(t, executor, what: str, axis: str | None) -> tuple[int, int]:
    """(the ranks on ``t``'s leading axis, the ranks of the carry): both
    the axis's size with the stacked executor; with an ``SPMDExecutor``
    the axis is the process's block of P and the carry spans its p, or
    with ``axis`` the processes along that axis of its mesh."""
    rows = t.shape[0]
    if not isinstance(executor, SPMDExecutor):
        if axis is not None:
            raise ValueError(f"a carry over axis {axis!r} runs on an "
                             f"SPMDExecutor's mesh")
        return rows, rows
    if rows != executor.ranks_per_proc:
        raise ValueError(f"{what}'s leading axis of {rows} is not the "
                         f"process's block of {executor.ranks_per_proc} "
                         f"ranks")
    if axis is None:
        return rows, executor.p
    return rows, executor.axis_sizes((axis,))[0]


def _run(pl, x, executor, axis: str | None):
    """``pl`` on payload ``x``: over the executor's ranks, or with
    ``axis`` over that axis of its mesh, each group of the other axes
    running it alike (``schedule.on_mesh``)."""
    if axis is None:
        return pl.execute(x, executor=executor)
    return executor.execute(on_mesh(pl.schedule(), (axis,), executor.mesh),
                            x, monoid_lib.get(pl.spec.monoid))


def _block(tree, executor):
    """A (P, ...) carry payload in the executor's block layout: without
    its rank axis where a process holds one rank (``lead`` 0)."""
    if isinstance(executor, SPMDExecutor) and not executor.lead:
        return tuple(t[0] for t in tree)
    return tree


class _SplitAffineFn(torch.autograd.Function):
    """The affine recurrence h_t = a_t·h_{t-1} + b_t over a sequence
    split into p shards, from h = 0 before the first token, with its
    backward.  ``a`` is (G, T, D/r) with G = P·B (rank major), the
    decay of r neighbouring columns of ``b`` (G, T, D), for the P ranks
    held here (all p of them with the stacked executor, a process's
    block with an ``SPMDExecutor``); ``exclusive`` says whether the
    trajectory returned is each position's state before (cp_wkv_scan)
    or after (cp_ssm_scan) its update.

    Forward: every shard's summary (A_total, h_final from zero) in one
    ``affine_chunk`` launch; the exclusive affine scan of the summaries
    across ranks (``spec``'s plan on ``executor``); every shard rescanned
    from its carry s_in in one launch.  The round kernels' affine
    instance takes two leaves of one shape, so A_total is materialised
    to the state's width first (exact: a product of broadcast decays
    stays broadcast).

    Backward, the same three steps in reverse order.  With λ the adjoint
    of the states, a shard's adjoint at its start is linear in the
    adjoint g_in that later ranks send to its last state: dh0 =
    dh0_local + A_total·g_in.  So g_in of rank r is the exclusive affine
    scan of (A_total, dh0_local) over the ranks taken in reverse order,
    the paper's collective again under the same plan; each shard then
    walks back from its g_in.  The stacked executor reverses the rank
    axis; an ``SPMDExecutor`` runs the plan on its mirrored view, where
    the ranks of every process are taken in reverse order, so no block
    moves."""

    @staticmethod
    def forward(ctx, a, b, rows: int, p: int, exclusive: bool, spec,
                executor, axis):
        G, T, D = b.shape
        bsz = G // rows
        _, _, a_tot, s_fin = scan_engine.affine_chunk(
            a, b, h_traj=False, a_final=True, h_final=True)
        pl = plan(spec, p, nbytes=carry_nbytes(bsz, D, D // a_tot.shape[-1],
                                               b.element_size()))
        _, s_in = _run(pl, _block((_state_width(a_tot, rows, bsz, D),
                                   s_fin.reshape(rows, bsz, D)), executor),
                       executor, axis)
        s_in = s_in.reshape(G, D).contiguous()
        _, h, _, _ = scan_engine.affine_chunk(a, b, h0=s_in,
                                              exclusive=exclusive)
        ctx.save_for_backward(a, h, s_in, a_tot)
        ctx.rows, ctx.exclusive = rows, exclusive
        # the backward runs this plan whatever thread autograd runs it on
        # (the cost model in force is the calling thread's), and counts
        # where this thread collects
        ctx.plan, ctx.executor, ctx.axis = pl, executor, axis
        ctx.thread = threading.get_ident()
        ctx.set_materialize_grads(False)
        return h

    @staticmethod
    def backward(ctx, gY):
        if gY is None:
            return (None,) * 8
        a, h, s_in, a_tot = ctx.saved_tensors
        G, T, D = h.shape
        p, ex = ctx.rows, ctx.exclusive
        bsz = G // p
        gY = gY.contiguous()
        # (i) each shard's adjoint at its start from its own outputs; the
        # launch also writes da and db, which are not needed here
        _, _, dh0 = scan_engine.affine_chunk_bwd(a, gY, None, h,
                                                 exclusive=ex)
        # (ii) the adjoint each rank's last state receives from the ranks
        # after it: the exclusive affine scan over the ranks in reverse
        # order (the flipped rank axis, or the processes' mirrored view)
        carry = (_state_width(a_tot, p, bsz, D), dh0.reshape(p, bsz, D))
        with stats_of_thread(ctx.thread):
            if isinstance(ctx.executor, SPMDExecutor):
                _, g_in = _run(ctx.plan, _block(carry, ctx.executor),
                               ctx.executor.mirrored(), ctx.axis)
            else:
                _, g_in = ctx.plan.execute(
                    tuple(t.flip(0) for t in carry), executor=ctx.executor)
                g_in = g_in.flip(0)
        g_in = g_in.reshape(G, D).contiguous()
        # (iii) each shard walked back from its g_in
        da, db, _ = scan_engine.affine_chunk_bwd(
            a, gY, g_in, h, h0=s_in, exclusive=ex, want_h0=False)
        return da, db, None, None, None, None, None, None


def carry_nbytes(bsz: int, D: int, r: int, itemsize: int) -> int:
    """The bytes the carry is planned on: one rank's (A_total, h_final)
    as the JAX package scans them, the decay total at its broadcast
    width D/r beside the state's D (B·H·hd·(hd + 1) for the wkv state,
    r = hd; 2·B·D for the SSM's, r = 1).  The wire carries the decay
    at the state's width (``_state_width``) until a round kernel takes
    a broadcast decay."""
    return bsz * (D // r + D) * itemsize


def _state_width(a_tot, p: int, bsz: int, D: int):
    """The shards' decay totals (p·B, D/r) as (p, B, D): each entry
    repeated over its r columns (a view where r = 1)."""
    r = D // a_tot.shape[-1]
    a_tot = a_tot.reshape(p, bsz, D // r, 1)
    return a_tot.expand(p, bsz, D // r, r).reshape(p, bsz, D)


def cp_ssm_scan(a, b, *, spec: ScanSpec | None = None,
                algorithm: str | None = None, executor=None):
    """h_t = a_t h_{t-1} + b_t over a sequence split into p shards.

    a, b: (p, B, S/p, ...) — the global (B, S, ...) split along S and
    stacked on a leading rank axis; with an ``SPMDExecutor``, (P, B,
    S/p, ...), this process's block of P ranks of the executor's p.
    Returns h of the same shape, from h = 0 before the first token.
    Three steps: every rank's shard summary (one launch), the exclusive
    affine scan of the summaries across ranks (``spec``'s plan for p
    ranks on ``executor``, by default the stacked executor on the
    tensors' device), and every rank's shard scan from its carry (one
    launch).  Differentiable: the backward is two ``affine_chunk_bwd``
    launches around the same plan run over the ranks in reverse order
    (:class:`_SplitAffineFn`).
    """
    if a.shape != b.shape or a.dim() < 3:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"share one (p, B, S/p, ...) shape")
    if executor is None:
        executor = StackedExecutor(a.device)
    rows, p = _ranks(a, executor, "a", None)
    _, bsz, seq = a.shape[:3]
    d = math.prod(a.shape[3:])
    h = _SplitAffineFn.apply(
        a.reshape(rows * bsz, seq, d).contiguous(),
        b.reshape(rows * bsz, seq, d).contiguous(), rows, p, False,
        _carry_spec(spec, algorithm), executor, None)
    return h.reshape(a.shape)


def cp_wkv_scan(w, kv, *, spec: ScanSpec | None = None,
                algorithm: str | None = None, executor=None,
                axis: str | None = None):
    """The RWKV wkv state scan S_t = w_t ⊙ S_{t-1} + kv_t over a
    sequence split into p shards, from S = 0 before the first token.

    w: (p, B, S/p, H, hd, 1) decays, broadcast over the value dim;
    kv: (p, B, S/p, H, hd, hd) outer products — the global (B, S, ...)
    split along S and stacked on a leading rank axis (with an
    ``SPMDExecutor``, this process's block of P ranks of the executor's
    p, or with ``axis`` (one rank a process) the carry runs over the
    processes along that axis of the executor's mesh, each group of the
    other axes alike: the reference's ``seq_axis``).  Returns the
    *pre-update* state S_{t-1} per position (as ``rwkv_block`` reads
    it), of kv's shape.  Three steps:

    1. every rank's shard summary from zero, (W_total, S_final): one
       ``affine_chunk`` launch with the decay as a broadcast leaf;
    2. the exclusive affine scan of the summaries across ranks
       (``spec``'s plan on ``executor``, by default the stacked
       executor on the tensors' device), W_total materialised to the
       state's (B, H, hd, hd);
    3. the correction S'_{t-1} = cumw_{t-1} ⊙ s_in + S_{t-1}, folded
       into one exclusive ``affine_chunk`` launch over the shard from
       the carry s_in (the reference adds a cumprod of the decays to a
       scan from zero; this rescan gives the same states without the
       cumprod trajectory).

    Differentiable as :func:`cp_ssm_scan`; dw comes back summed over
    the value dim, the broadcast the forward applies.
    """
    if kv.dim() != 6 or w.shape != kv.shape[:5] + (1,):
        raise ValueError(f"w {tuple(w.shape)} and kv {tuple(kv.shape)} must "
                         f"be (p, B, S/p, H, hd, 1) and (p, B, S/p, H, hd, "
                         f"hd)")
    if executor is None:
        executor = StackedExecutor(kv.device)
    rows, p = _ranks(kv, executor, "kv", axis)
    _, bsz, seq, heads, hd = kv.shape[:5]
    s_prev = _SplitAffineFn.apply(
        w.reshape(rows * bsz, seq, heads * hd).contiguous(),
        kv.reshape(rows * bsz, seq, heads * hd * hd).contiguous(), rows, p,
        True, _carry_spec(spec, algorithm), executor, axis)
    return s_prev.reshape(kv.shape)
