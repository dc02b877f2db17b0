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
from repro_torch.models.shards import WHOLE, Shards
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


def mamba_block(cfg, p, x, *, cache=None, shards: Shards = WHOLE):
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
    ``WHOLE`` is one part, the leaves whole."""
    B, S, _ = x.shape
    ds = cfg.d_state
    dtr = P.dt_rank(cfg)
    xn = shards.enter(rmsnorm(x, p["norm1"], cfg.norm_eps))
    x_cs, zs, parts = [], [], []
    for j in shards.ids:
        xz = constrain(xn @ shards.of(p, "in_proj", j), "batch", "seq",
                       "d_inner", site="mamba.in_proj")
        di = xz.shape[-1] // 2  # this part's channels
        x_in, z = xz[..., :di], xz[..., di:]
        conv = None if cache is None else shards.cache_of(cache["conv"], j)
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

    parts = []
    for j, x_c, z in zip(shards.ids, x_cs, zs):
        dt = F.softplus(dt_raw @ shards.of(p, "dt_proj", j)
                        + shards.of(p, "dt_bias", j))  # (B,S,di)
        a_mat = -torch.exp(shards.of(p, "a_log", j).float())  # (di, ds)
        # discretize: a = exp(dt*A) ; b = dt * B_t * x_t
        a = torch.exp(dt.float()[..., None] * a_mat)  # (B,S,di,ds)
        b = (dt * x_c).float()[..., None] * b_ssm.float()[:, :, None, :]

        h = None if cache is None else shards.cache_of(cache["h"], j)
        if h is None:
            h0 = torch.zeros((B, *a_mat.shape), dtype=torch.float32,
                             device=x.device)
            hs, _ = ssm_scan_chunked(a, b, h0)
        elif S == 1:  # decode
            hs = a * h[:, None] + b
            h.copy_(hs[:, -1])
        else:  # prefill into cache
            hs, new_h = ssm_scan_chunked(a, b, h)
            h.copy_(new_h)
        y = torch.einsum("bsin,bsn->bsi", hs, c_ssm.float())
        y = (y.to(x.dtype) + x_c * shards.of(p, "d_skip", j)) * F.silu(z)
        parts.append(y @ shards.of(p, "out_proj", j))
    out = constrain(shards.reduce(parts), "batch", "seq", "embed_act",
                    site="mamba.out_proj")
    return x + out, cache


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
