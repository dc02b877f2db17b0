"""Context-parallel SSM prefill through the paper's exscan, on one card.

With the sequence split into p shards, each rank scans only its shard;
the carry entering rank r is the composition of ALL earlier ranks'
shard summaries — an exclusive prefix "sum" under the (associative,
costly, non-commutative) state composition of the affine monoid:

    mamba / diagonal SSM:  (A, B) with  h_out = A * h_in + B
    rwkv (matrix state):   (W, S) with  S_out = diag(W) S_in + S

This is the paper's headline scenario: m is one state vector, ⊕ is
costly, and the number of rounds dominates.  As everywhere in the port
the p ranks sit on a leading axis of one card's tensors, so the shards
of all ranks are scanned by one launch and the cross-rank carry runs
the planner's schedule through the stacked executor and the affine
round kernels.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.scan_api import ScanSpec, scan
from repro_torch.core.schedule import StackedExecutor
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


def _no_grad_yet(name: str, *ts) -> None:
    """The cp scans run the affine round kernels, which have no backward
    yet: under autograd their carry would give zero gradients silently,
    so they refuse."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name} has no backward yet: the affine round kernels' "
            f"gradient is still to port (ROADMAP.md, Queue 1 item 5)")


def cp_ssm_scan(a, b, *, spec: ScanSpec | None = None,
                algorithm: str | None = None, executor=None):
    """h_t = a_t h_{t-1} + b_t over a sequence split into p shards.

    a, b: (p, B, S/p, ...) — the global (B, S, ...) split along S and
    stacked on a leading rank axis.  Returns h of the same shape, from
    h = 0 before the first token.  Three steps: every rank's shard
    summary (one launch), the exclusive affine scan of the summaries
    across ranks (``spec``'s plan on ``executor``, by default the
    stacked executor on the tensors' device), and every rank's shard
    scan from its carry (one launch).
    """
    _no_grad_yet("cp_ssm_scan", a, b)
    if a.shape != b.shape or a.dim() < 3:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"share one (p, B, S/p, ...) shape")
    p, bsz, seq = a.shape[:3]
    state = tuple(a.shape[3:])
    d = math.prod(state)
    a3 = a.reshape(p * bsz, seq, d).contiguous()
    b3 = b.reshape(p * bsz, seq, d).contiguous()
    a_tot, b_tot = scan_engine.affine_chunk_summary(a3, b3)
    if executor is None:
        executor = StackedExecutor(a.device)
    _, h_in = scan((a_tot.reshape(p, bsz, d), b_tot.reshape(p, bsz, d)),
                   _carry_spec(spec, algorithm), executor=executor)
    h, _ = scan_engine.affine_chunk_scan(a3, b3,
                                         h_in.reshape(p * bsz, d))
    return h.reshape(a.shape)


def cp_wkv_scan(w, kv, *, spec: ScanSpec | None = None,
                algorithm: str | None = None, executor=None):
    """The RWKV wkv state scan S_t = w_t ⊙ S_{t-1} + kv_t over a
    sequence split into p shards, from S = 0 before the first token.

    w: (p, B, S/p, H, hd, 1) decays, broadcast over the value dim;
    kv: (p, B, S/p, H, hd, hd) outer products — the global (B, S, ...)
    split along S and stacked on a leading rank axis.  Returns the
    *pre-update* state S_{t-1} per position (as ``rwkv_block`` reads
    it), of kv's shape.  Three steps:

    1. every rank's shard summary from zero, (W_total, S_final): one
       ``affine_chunk`` launch with the decay as a broadcast leaf;
    2. the exclusive affine scan of the summaries across ranks
       (``spec``'s plan on ``executor``, by default the stacked
       executor on the tensors' device).  The round kernels' affine
       instance takes two leaves of one shape, so W_total is
       materialised to the state's (B, H, hd, hd) first: exact, since
       a product of broadcast decays stays broadcast;
    3. the correction S'_{t-1} = cumw_{t-1} ⊙ s_in + S_{t-1}, folded
       into one exclusive ``affine_chunk`` launch over the shard from
       the carry s_in (the reference adds a cumprod of the decays to a
       scan from zero; this rescan gives the same states without the
       cumprod trajectory).
    """
    _no_grad_yet("cp_wkv_scan", w, kv)
    if kv.dim() != 6 or w.shape != kv.shape[:5] + (1,):
        raise ValueError(f"w {tuple(w.shape)} and kv {tuple(kv.shape)} must "
                         f"be (p, B, S/p, H, hd, 1) and (p, B, S/p, H, hd, "
                         f"hd)")
    p, bsz, seq, heads, hd = kv.shape[:5]
    d = heads * hd * hd
    wa = w.reshape(p * bsz, seq, heads * hd).contiguous()
    kb = kv.reshape(p * bsz, seq, d).contiguous()
    _, _, w_tot, s_fin = scan_engine.affine_chunk(
        wa, kb, h_traj=False, a_final=True, h_final=True)
    w_full = w_tot.reshape(p, bsz, heads * hd, 1).expand(
        p, bsz, heads * hd, hd).reshape(p, bsz, d)
    if executor is None:
        executor = StackedExecutor(kv.device)
    _, s_in = scan((w_full, s_fin.reshape(p, bsz, d)),
                   _carry_spec(spec, algorithm), executor=executor)
    _, s_prev, _, _ = scan_engine.affine_chunk(
        wa, kb, h0=s_in.reshape(p * bsz, d).contiguous(), exclusive=True)
    return s_prev.reshape(kv.shape)
