"""RWKV6 ("Finch") block: data-dependent-decay linear attention, from the
JAX package's ``models/rwkv.py``.

State per head is a (hd, hd) matrix updated as
    S_t = diag(w_t) S_t-1 + k_t ⊗ v_t,      out_t = r_t · (S_t-1 + u⊙k_t ⊗ v_t)
— an affine-monoid recurrence.  The reference walks ``WKV_CHUNK``-row
chunks with an outer ``lax.scan`` and a log-depth associative scan in
each.  Here the whole recurrence is ONE launch of the chunked-scan
engine's affine kernel: the batch is its group axis, the state's
H·hd·hd entries its columns, and the decay ``w`` a broadcast leaf of
H·hd entries, one per key row, each serving the hd value columns of
its row (``scan_engine.affine_chunk``'s r = hd), so the decay is never
materialised to the state's shape.  Under the fsdp_sp strategy the
sequence is split over the "model" ranks and the carry across them is
the paper's exscan (``models/context_parallel.cp_wkv_scan``), in
training too: its backward runs the same plan over the ranks in
reverse order.

Simplifications vs the published RWKV6, as in the reference: the
data-dependent decay uses one linear projection instead of the
LoRA-factored one, and the group-norm on the wkv output is an RMS norm
per head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import scan_engine
from repro_torch.models.common import rmsnorm, token_shift
from repro_torch.models.shards import WHOLE, WHOLE_D, Shards
from repro_torch.sharding.ctx import constrain

HEAD_DIM = 64
# The reference's chunk length (its XLA scan's unit); the kernel walks
# the sequence in one pass and needs no chunking, so this only names
# the reference's value.
WKV_CHUNK = 32


def _lerp(x, prev, mu):
    return x + (prev - x) * mu


def wkv_scan_chunked(w, kv, s0):
    """S_t = w_t * S_{t-1} + kv_t.  w: (B,S,H,hd,1) (the decay, broadcast
    over the value dim), kv: (B,S,H,hd,hd), s0: (B,H,hd,hd).

    Returns (S_prev per step: (B,S,H,hd,hd), S_final: (B,H,hd,hd)) —
    the *exclusive* (pre-update) state, as the wkv output reads
    S_{t-1}.  One ``affine_chunk`` launch, exclusive, from h0 = s0;
    differentiable, its backward one ``affine_chunk_bwd`` launch
    (``scan_engine.AffineChunkFn``)."""
    B, S, H, hd, _ = kv.shape
    s_prev, s_final = scan_engine.affine_chunk_h(
        w.reshape(B, S, H * hd).contiguous(),
        kv.reshape(B, S, H * hd * hd).contiguous(),
        s0.reshape(B, H * hd * hd).contiguous(), exclusive=True)
    return s_prev.reshape(kv.shape), s_final.reshape(B, H, hd, hd)


def _split(x, p):
    """(B, S, ...) -> (p, B, S/p, ...)."""
    B, S = x.shape[:2]
    return x.reshape(B, p, S // p, *x.shape[2:]).transpose(0, 1).contiguous()


def _join(x):
    """(p, B, S/p, ...) -> (B, S, ...)."""
    p, B, s = x.shape[:3]
    return x.transpose(0, 1).reshape(B, p * s, *x.shape[3:])


def rwkv_block(cfg, p, x, *, cache=None, mesh=None, shards: Shards = WHOLE,
               cm_shards: Shards = WHOLE, seq=None, dsl=WHOLE_D):
    """Full RWKV6 layer (time-mix + channel-mix).  x: (B, S, d).

    cache: {"shift": (B,1,d), "cm_shift": (B,1,d), "state": (B,H,hd,hd)
    fp32}, updated in place and returned (decode at S = 1, prefill
    into the cache at S > 1).

    ``shards`` (``models.shards``) splits the time mix over the "model"
    ranks by whole wkv heads: each part projects its heads' r, k, v, g
    and decay, scans its heads' states (its part of the cache's
    "state", ``shards.cache_of``) and multiplies by its rows of wo;
    ``cm_shards`` splits the channel mix's d_ff: each part its columns
    of cm_wk and rows of cm_wv.  Each row-split product's partials are
    summed by ``reduce`` (one all-reduce over processes); the token
    shifts are of the normed input, whole, and so is ``cm_wr``.  Under
    autograd the shifted inputs the parts multiply (r, k, v, g and the
    decay's, then the channel mix's k) ``shards.enter``: their
    gradients are summed over the parts, the five of the time mix in
    one bucket, so the shifts' μ, whole, get the whole gradient.
    ``WHOLE`` is one part, the leaves whole.

    Under the fsdp_sp strategy (sequence split over the "model" ranks
    of ``mesh``) the wkv recurrence of a full-sequence call runs
    context-parallel: each rank's shard scanned from zero, the paper's
    exscan (``cfg.scan_spec``) carrying the (decay, state) affine
    monoid across ranks, each shard rescanned from its carry.  Over
    processes (``seq``, a ``models.shards.SeqShard``) x is this
    process's shard: the token shifts read the previous shard's last
    row (``seq.prev_row``) and the carry is the same exscan over the
    "model" processes of this data rank, in messages
    (``cp_wkv_scan(..., axis="model")`` on the process's executor).

    ``dsl`` (``models.shards.DSlices``, decode_ws's d over "data"): x,
    the token shifts and their caches hold d as ``dsl`` says (every row,
    the slice's channels); the five projections' partials from it are
    summed in one reduction, and the channel mix's k and r in another;
    the wkv scan runs on the rows of each of ``dsl``'s blocks against
    those rows of the state cache, its output comes back to every row,
    and wo and cm_wv write x's part of d."""
    B, S, d = x.shape
    hd = HEAD_DIM

    # ---------------- time mix ----------------
    xn = rmsnorm(x, p["norm1"], cfg.norm_eps, dsl)
    prev = cache["shift"] if cache is not None else \
        None if seq is None else seq.prev_row(xn)
    xp = token_shift(xn, prev)
    xr = _lerp(xn, xp, dsl.chan(p["mu_r"]))
    xk = _lerp(xn, xp, dsl.chan(p["mu_k"]))
    xv = _lerp(xn, xp, dsl.chan(p["mu_v"]))
    xw = _lerp(xn, xp, dsl.chan(p["mu_w"]))
    xg = _lerp(xn, xp, dsl.chan(p["mu_g"]))
    xr, xk, xv, xw, xg = shards.enter(xr, xk, xv, xw, xg)
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    use_cp = (cache is None and mesh is not None
              and cfg.sharding_strategy == "fsdp_sp"
              and S % tp == 0 and S >= tp and tp > 1)
    parts = []
    for j in shards.ids:
        r, k, v, g, wd = dsl.dots([
            (xr, shards.of(p, "wr", j)), (xk, shards.of(p, "wk", j)),
            (xv, shards.of(p, "wv", j)), (xg, shards.of(p, "wg", j)),
            (xw, shards.of(p, "w_decay", j))])
        H = r.shape[-1] // hd  # this part's heads
        r = constrain(r, "batch", "seq", "heads",
                      site="rwkv.wr").reshape(B, S, H, hd)
        k = constrain(k, "batch", "seq", "heads",
                      site="rwkv.wk").reshape(B, S, H, hd)
        v = constrain(v, "batch", "seq", "heads",
                      site="rwkv.wv").reshape(B, S, H, hd)
        g = F.silu(constrain(g, "batch", "seq", "heads", site="rwkv.wg"))
        # Finch data-dependent decay in (0, 1)
        logw = -torch.exp(torch.clamp(
            wd + shards.of(p, "decay_bias", j), -8.0, 4.0).float())
        w = torch.exp(logw).reshape(B, S, H, hd)
        u = shards.of(p, "bonus_u", j).reshape(H, hd)
        state = None if cache is None else shards.cache_of(cache["state"], j)
        outs = []
        for lo, hi in dsl.blocks(B):
            outs.append(_wkv_rows(
                cfg, r[lo:hi], k[lo:hi], v[lo:hi], w[lo:hi], u,
                None if state is None else dsl.rows_of(state, lo, hi),
                seq=seq, tp=tp if use_cp else 1).to(x.dtype))
        out = dsl.join_rows(outs, B) * g
        parts.append(dsl.out(out, shards.of(p, "wo", j)))
    x = x + constrain(shards.reduce(parts), "batch", "seq", "embed_act",
                      site="rwkv.wo")

    # ---------------- channel mix ----------------
    xn2 = rmsnorm(x, p["norm2"], cfg.norm_eps, dsl)
    prev2 = cache["cm_shift"] if cache is not None else \
        None if seq is None else seq.prev_row(xn2)
    xp2 = token_shift(xn2, prev2)
    xk2 = cm_shards.enter(_lerp(xn2, xp2, dsl.chan(p["mu_ck"])))
    xr2 = _lerp(xn2, xp2, dsl.chan(p["mu_cr"]))
    *ks, rr = dsl.dots([(xk2, cm_shards.of(p, "cm_wk", j))
                        for j in cm_shards.ids] + [(xr2, p["cm_wr"])])
    cm = cm_shards.reduce([dsl.out(torch.square(F.relu(constrain(
        kk, "batch", "seq", "mlp", site="rwkv.cm_wk"))),
        cm_shards.of(p, "cm_wv", j)) for j, kk in zip(cm_shards.ids, ks)])
    rr = dsl.chan(torch.sigmoid(rr))
    x = x + rr * cm

    new_cache = None
    if cache is not None:
        cache["shift"].copy_(xn[:, -1:])
        cache["cm_shift"].copy_(xn2[:, -1:])
        new_cache = cache
    return x, new_cache


def _wkv_rows(cfg, r, k, v, w, u, state, *, seq, tp: int):
    """The wkv of rows' r, k, v (B_r, S, H, hd) and decay w: each head's
    state scanned from zero (no cache: one ``affine_chunk`` launch, or
    over ``seq``'s "model" processes or ``tp`` stacked ranks the
    context-parallel scan) or from those rows' ``state`` (B_r, H, hd,
    hd), updated in place (decode at S = 1: one step); each position
    reads its exclusive state and the bonus, and the per-head RMS norm.
    Returns (B_r, S, H·hd) fp32."""
    B, S, H, hd = r.shape
    kv = k.float()[..., :, None] * v.float()[..., None, :]  # (B,S,H,hd,hd)
    w_b = w[..., :, None]  # decay broadcasts over the v dim
    if seq is not None:
        from repro_torch.models.context_parallel import cp_wkv_scan

        s_prev = cp_wkv_scan(w_b[None], kv[None], spec=cfg.scan_spec,
                             executor=seq.ex, axis="model")[0]
        s_final = None
    elif tp > 1:
        from repro_torch.models.context_parallel import cp_wkv_scan

        s_prev = _join(cp_wkv_scan(_split(w_b, tp), _split(kv, tp),
                                   spec=cfg.scan_spec))
        s_final = None  # training path: final state unused
    elif state is None:
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
        s_prev, s_final = wkv_scan_chunked(w_b, kv, s0)
    elif S == 1:  # decode
        s_prev = state[:, None]
        s_final = w_b[:, 0] * state + kv[:, 0]
    else:  # prefill into cache
        s_prev, s_final = wkv_scan_chunked(w_b, kv, state)

    att = s_prev + u.float()[..., :, None] * kv
    del kv
    out = torch.einsum("bshi,bshij->bshj", r.float(), att)
    del att, s_prev
    # per-head RMS norm (stand-in for reference group-norm)
    var = torch.mean(out * out, dim=-1, keepdim=True)
    out = out * torch.rsqrt(var + cfg.norm_eps)
    if state is not None:
        state.copy_(s_final)
    return out.reshape(B, S, H * hd)


def init_rwkv_cache(cfg, batch, dtype, device, heads: int | None = None):
    """A layer's cache; ``heads``: the wkv heads its state holds (a
    part's, ``rwkv_block``'s ``shards``), all d/hd by default."""
    d = cfg.d_model
    H = d // HEAD_DIM if heads is None else heads
    return {
        "shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, HEAD_DIM, HEAD_DIM),
                             dtype=torch.float32, device=device),
    }
