"""Mamba (selective SSM) block, from the JAX package's
``models/mamba.py``.

The JAX model walks ``SSM_CHUNK``-sized chunks with an outer
``lax.scan`` and solves each chunk with a log-depth associative scan.
Here the whole recurrence is one launch of the chunked-scan engine's
affine kernel: the batch is its group axis and the trailing state dims
(d_inner × d_state) its columns, so each column is walked once, in
order, with the state in a register.  Around it, ``mamba_block`` is
the reference's projections, depthwise causal conv (with its decode
carry) and gating, in plain torch.

Context parallelism: when the sequence is split over ranks, the carry
across ranks is the paper's exscan under the affine monoid
(``models/context_parallel.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import scan_engine
from repro_torch.models import params as P
from repro_torch.models.common import rmsnorm
from repro_torch.models.shards import WHOLE, WHOLE_D, Shards
from repro_torch.sharding.ctx import constrain

# The JAX model's chunk length (its XLA scan's unit); the kernel walks
# the sequence in one pass and needs no chunking, so this only names
# the reference's value.
SSM_CHUNK = 64


def ssm_scan_chunked(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, S, ...);
    h0: (B, ...).

    Returns (h: (B, S, ...), h_final: (B, ...)), differentiable: the
    backward is one ``affine_chunk_bwd`` launch
    (``scan_engine.AffineChunkFn``).
    """
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    bsz, seq = a.shape[:2]
    state = tuple(a.shape[2:])
    d = math.prod(state)
    h, h_final = scan_engine.affine_chunk_scan(
        a.reshape(bsz, seq, d).contiguous(),
        b.reshape(bsz, seq, d).contiguous(),
        h0.reshape(bsz, d).contiguous())
    return h.reshape(a.shape), h_final.reshape((bsz,) + state)


def _causal_conv(x, conv_w, conv_b, prev=None):
    """Depthwise causal conv along seq.  x: (B,S,di), conv_w: (K,di).

    prev: (B, K-1, di) carry for decode/chunked mode (None = zero pad).
    Returns (y, new_prev)."""
    K = conv_w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * conv_w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * conv_w[i]
    return y + conv_b, xp[:, xp.shape[1] - (K - 1):]


def mamba_block(cfg, p, x, *, cache=None, shards: Shards = WHOLE,
                dsl=WHOLE_D):
    """Pre-norm Mamba sub-block.  x: (B, S, d).

    cache: {"conv": (B, K-1, di), "h": (B, di, ds) fp32}, updated in
    place and returned (decode at S = 1, prefill into the cache at
    S > 1).  Returns (residual_out, new_cache).

    ``shards`` (``models.shards``) splits the d_inner channels over the
    "model" ranks: each part holds its x_in channels and their gates z
    (``in_proj``'s pair of column ranges), their conv, dt, A, D and
    ``out_proj`` rows, and its part of the cache (``shards.cache_of``).
    ``x_proj``'s product (dt_raw, B, C) is a partial over the channels,
    so the parts meet twice: its partials are summed by ``reduce``, then
    each part discretises and scans its channels, and ``out_proj``'s
    partials are summed.  Under autograd each part reads two replicated
    inputs of its own (the normed x, and the summed (dt_raw, B, C)), so
    both ``shards.enter``: their gradients are summed over the parts.
    ``WHOLE`` is one part, the leaves whole.

    ``dsl`` (``models.shards.DSlices``, decode_ws's d over "data"): x
    holds d as ``dsl`` says; in_proj's partials from it are summed in
    one reduction, the conv and the scan run on the rows of each of
    ``dsl``'s blocks against those rows of the caches, the gated output
    comes back to every row, and out_proj writes x's part of d."""
    B, S, _ = x.shape
    xn = shards.enter(rmsnorm(x, p["norm1"], cfg.norm_eps, dsl))
    xzs = [constrain(xz, "batch", "seq", "d_inner", site="mamba.in_proj")
           for xz in dsl.dots([(xn, shards.of(p, "in_proj", j))
                               for j in shards.ids])]
    ys = [[] for _ in shards.ids]
    for lo, hi in dsl.blocks(B):
        part = None if cache is None else {
            k: [dsl.rows_of(shards.cache_of(cache[k], j), lo, hi)
                for j in shards.ids] for k in ("conv", "h")}
        for y, got in zip(ys, _mamba_rows(cfg, p, [xz[lo:hi] for xz in xzs],
                                          part, shards, x.dtype)):
            y.append(got)
    out = constrain(shards.reduce([
        dsl.out(dsl.join_rows(y, B), shards.of(p, "out_proj", j))
        for j, y in zip(shards.ids, ys)]), "batch", "seq", "embed_act",
        site="mamba.out_proj")
    return x + out, cache


def _mamba_rows(cfg, p, xzs, cache, shards: Shards, dtype) -> list:
    """The gated SSM output (B_r, S, di) of each part of rows' in_proj
    products ``xzs`` (x_in | z of its channels), against ``cache``
    ({"conv", "h"}: each part's rows, updated in place) or from zero:
    the conv, x_proj's partials summed over the parts, the discretised
    scan and the gate."""
    B, S = xzs[0].shape[:2]
    ds = cfg.d_state
    dtr = P.dt_rank(cfg)
    x_cs, zs, parts = [], [], []
    for n, (j, xz) in enumerate(zip(shards.ids, xzs)):
        di = xz.shape[-1] // 2  # this part's channels
        x_in, z = xz[..., :di], xz[..., di:]
        conv = None if cache is None else cache["conv"][n]
        x_c, new_conv = _causal_conv(x_in, shards.of(p, "conv_w", j),
                                     shards.of(p, "conv_b", j), conv)
        if conv is not None:
            conv.copy_(new_conv)
        x_c = F.silu(x_c)
        x_cs.append(x_c)
        zs.append(z)
        parts.append(x_c @ shards.of(p, "x_proj", j))
    dbc = shards.enter(shards.reduce(parts))
    dt_raw = dbc[..., :dtr]
    b_ssm = dbc[..., dtr:dtr + ds]
    c_ssm = dbc[..., dtr + ds:]

    ys = []
    for n, (j, x_c, z) in enumerate(zip(shards.ids, x_cs, zs)):
        dt = F.softplus(dt_raw @ shards.of(p, "dt_proj", j)
                        + shards.of(p, "dt_bias", j))  # (B,S,di)
        a_mat = -torch.exp(shards.of(p, "a_log", j).float())  # (di, ds)
        # discretize: a = exp(dt*A) ; b = dt * B_t * x_t
        a = torch.exp(dt.float()[..., None] * a_mat)  # (B,S,di,ds)
        b = (dt * x_c).float()[..., None] * b_ssm.float()[:, :, None, :]

        h = None if cache is None else cache["h"][n]
        if h is None:
            h0 = torch.zeros((B, *a_mat.shape), dtype=torch.float32,
                             device=x_c.device)
            hs, _ = ssm_scan_chunked(a, b, h0)
        elif S == 1:  # decode
            hs = a * h[:, None] + b
            h.copy_(hs[:, -1])
        else:  # prefill into cache
            hs, new_h = ssm_scan_chunked(a, b, h)
            h.copy_(new_h)
        y = torch.einsum("bsin,bsn->bsi", hs, c_ssm.float())
        ys.append((y.to(dtype) + x_c * shards.of(p, "d_skip", j)) *
                  F.silu(z))
    return ys


def init_mamba_cache(cfg, batch, dtype, device, d_inner: int | None = None):
    """A layer's cache; ``d_inner``: the channels it holds (a part's,
    ``mamba_block``'s ``shards``), all of ``cfg.d_inner`` by default."""
    di = cfg.d_inner if d_inner is None else d_inner
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                         device=device),
    }
