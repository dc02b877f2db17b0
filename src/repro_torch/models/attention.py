"""GQA attention: chunked full-sequence path + cached decode path, from
the JAX package's ``models/attention.py``.

The (S, S) score matrix is never materialised whole: the query axis is
processed in ``cfg.attn_chunk`` chunks (q-chunk scores are (B, KV, G,
C, S)).  GQA is computed in grouped form (no KV repetition).  The JAX
package has no Pallas attention, so the port is plain torch too: the
reference's einsums and masked softmax, written as it writes them,
because the score softcap and the sliding window have to match it.

Variants: RoPE, attention-score softcap (gemma2), sliding window
(gemma2 local layers), non-causal (hubert encoder).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import rmsnorm, rope, softcap
from repro_torch.models.shards import WHOLE, WHOLE_D, Shards
from repro_torch.sharding.ctx import constrain

NEG_INF = -1e30


def _grouped_scores(q, k, scale, cap):
    """q: (B,C,KV,G,hd)  k: (B,S,KV,hd)  ->  (B,KV,G,C,S) fp32."""
    s = torch.einsum("bckgd,bskd->bkgcs", q.float(), k.float())
    return softcap(s * scale, cap)


def _attend(scores, v):
    """scores: (B,KV,G,C,S) f32; v: (B,S,KV,hd) -> (B,C,KV,G,hd)."""
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgcs,bskd->bckgd", w.to(v.dtype), v)


def attention_core(q, k, v, pos_q, pos_k, *, causal: bool, window: int,
                   attn_softcap: float, chunk: int, kv_len=None):
    """q: (B, Sq, H, hd), k and v: (B, Skv, KV, hd), rope applied;
    pos_q (B, Sq) and pos_k (B, Skv) int; kv_len (B,) the valid cache
    length (decode).  Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)
    pk = pos_k[:, None, None, None, :]

    def block(qc, pq):
        scores = _grouped_scores(qc, k, scale, attn_softcap)
        mask = torch.ones((B, 1, 1, qc.shape[1], k.shape[1]), dtype=torch.bool,
                          device=q.device)
        pqe = pq[:, None, None, :, None]
        if causal:
            mask = mask & (pk <= pqe)
        if window:
            mask = mask & (pk > pqe - window)
        if kv_len is not None:
            mask = mask & (pk < kv_len[:, None, None, None, None])
        return _attend(torch.where(mask, scores, NEG_INF), v)

    if Sq <= chunk:
        out = block(qg, pos_q)
    else:
        if Sq % chunk:
            raise ValueError(f"{Sq} query positions in chunks of {chunk}")
        out = torch.cat([block(qg[:, i:i + chunk], pos_q[:, i:i + chunk])
                         for i in range(0, Sq, chunk)], dim=1)
    return out.reshape(B, Sq, H, hd)


def attention_block(cfg, p: dict, x, positions, *, window: int,
                    cache: dict | None = None, cache_len: int | None = None,
                    shards: Shards = WHOLE, seq=None, dsl=WHOLE_D):
    """Pre-norm attention sub-block.  Returns (residual_out, new_cache).

    Full-sequence mode (cache=None): self-attention over x.  Cache mode:
    the cache holds (k, v) of shape (B, S_max, KVd, hd) with
    ``cache_len`` valid entries, the kv heads duplicated KVd / KV times
    (to the TP degree, ``launch.steps.kv_dup``; the new k and v are
    repeated to match, as in the reference); x's S new entries are
    written into it in place at [cache_len, cache_len + S) (the port
    keeps one cache and updates it, where the reference returns a new
    one), and it is returned.

    ``shards`` (``models.shards``) splits the heads over the "model"
    ranks: each part takes its q heads, the kv heads they read and its
    part of the cache, attends, and multiplies by its rows of wo; the
    partials are summed by ``shards.reduce`` (one all-reduce over
    processes; under autograd the normed input's gradient is summed at
    ``shards.enter``).  ``WHOLE`` is one part, the leaves whole.

    ``seq`` (``models.shards.SeqShard``, fsdp_sp over processes): x
    holds this process's positions of a sequence split over the "model"
    processes, ``positions`` their absolute places; each shard's k and v
    are all-gathered after RoPE (the reference's "seq_kv" unsplit) and
    the local queries attend to the whole sequence's keys at their
    absolute positions, so the causal mask and the sliding window are
    the whole sequence's.  Full-sequence mode only.

    ``dsl`` (``models.shards.DSlices``, decode_ws's d over "data"): x
    holds d as ``dsl`` says; the q, k and v partials from it are summed
    in one reduction, the core runs on the rows of each of ``dsl``'s
    blocks (the rows the cache holds there), its output comes back to
    every row, and wo writes x's part of d.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim_
    xn = shards.enter(rmsnorm(x, p["norm1"], cfg.norm_eps, dsl))
    parts = []
    for j in shards.ids:
        q, k, v = dsl.dots([(xn, shards.of(p, name, j))
                            for name in ("wq", "wk", "wv")])
        q = constrain(q, "batch", "seq", "heads",
                      site="attn.wq").reshape(B, S, -1, hd)
        k = constrain(k, "batch", "seq_kv", "kv_heads",
                      site="attn.wk").reshape(B, S, -1, hd)
        v = constrain(v, "batch", "seq_kv", "kv_heads",
                      site="attn.wv").reshape(B, S, -1, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

        outs = []
        for lo, hi in dsl.blocks(B):
            outs.append(_attend_rows(
                cfg, q[lo:hi], k[lo:hi], v[lo:hi], positions[lo:hi],
                window=window, seq=seq, cache_len=cache_len,
                cache=None if cache is None else tuple(
                    dsl.rows_of(shards.cache_of(cache[n], j), lo, hi)
                    for n in ("k", "v"))))
        out = dsl.join_rows(outs, B)
        parts.append(dsl.out(out.reshape(B, S, -1), shards.of(p, "wo", j)))
    y = constrain(shards.reduce(parts), "batch", "seq", "embed_act",
                  site="attn.wo")
    return x + y, cache


def _attend_rows(cfg, q, k, v, positions, *, window: int, seq, cache,
                 cache_len):
    """``attention_core`` of rows' q, k and v (B_r, S, ·, hd), after
    RoPE: over the call's keys (``seq``'s whole sequence where it splits
    it), or, with ``cache`` = (ck, cv) those rows' cache (B_r, S_max,
    KVd, hd), written at [cache_len, cache_len + S) first.  Returns
    (B_r, S, H, hd)."""
    B, S = q.shape[:2]
    if cache is None:
        pos_k = positions
        if seq is not None:
            k, v = seq.gather_kv(k, v)
            pos_k = torch.arange(seq.S, dtype=torch.int32,
                                 device=q.device).expand(B, seq.S)
        return attention_core(q, k, v, positions, pos_k,
                              causal=cfg.causal, window=window,
                              attn_softcap=cfg.attn_softcap,
                              chunk=cfg.attn_chunk)
    ck, cv = cache
    dup = ck.shape[2] // k.shape[2]
    if dup > 1:  # the cache holds kv heads duplicated dup times
        k = k.repeat_interleave(dup, dim=2)
        v = v.repeat_interleave(dup, dim=2)
    if cache_len + S > ck.shape[1]:
        raise ValueError(f"{cache_len} cached + {S} new positions "
                         f"exceed the cache's {ck.shape[1]}")
    ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
    cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
    S_max = ck.shape[1]
    pos_k = torch.arange(S_max, dtype=torch.int32,
                         device=q.device).expand(B, S_max)
    kv_len = torch.full((B,), cache_len + S, dtype=torch.int32,
                        device=q.device)
    return attention_core(q, ck, cv, positions, pos_k,
                          causal=cfg.causal, window=window,
                          attn_softcap=cfg.attn_softcap,
                          chunk=cfg.attn_chunk, kv_len=kv_len)
