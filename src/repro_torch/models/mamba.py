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


def mamba_block(cfg, p, x, *, cache=None):
    """Pre-norm Mamba sub-block.  x: (B, S, d).

    cache: {"conv": (B, K-1, di), "h": (B, di, ds) fp32}, updated in
    place and returned (decode at S = 1, prefill into the cache at
    S > 1).  Returns (residual_out, new_cache)."""
    B, S, _ = x.shape
    di, ds = cfg.d_inner, cfg.d_state
    dtr = P.dt_rank(cfg)
    xn = rmsnorm(x, p["norm1"], cfg.norm_eps)
    xz = constrain(xn @ p["in_proj"], "batch", "seq", "d_inner",
                   site="mamba.in_proj")
    x_in, z = xz[..., :di], xz[..., di:]

    conv_prev = cache["conv"] if cache is not None else None
    x_c, new_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"], conv_prev)
    x_c = F.silu(x_c)

    dbc = x_c @ p["x_proj"]
    dt_raw = dbc[..., :dtr]
    b_ssm = dbc[..., dtr:dtr + ds]
    c_ssm = dbc[..., dtr + ds:]
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])  # (B,S,di)
    a_mat = -torch.exp(p["a_log"].float())  # (di, ds)
    # discretize: a = exp(dt*A) ; b = dt * B_t * x_t
    a = torch.exp(dt.float()[..., None] * a_mat)  # (B,S,di,ds)
    b = (dt * x_c).float()[..., None] * b_ssm.float()[:, :, None, :]

    if cache is None:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
        hs, new_h = ssm_scan_chunked(a, b, h0)
    elif S == 1:  # decode
        hs = a * cache["h"][:, None] + b
        new_h = hs[:, -1]
    else:  # prefill into cache
        hs, new_h = ssm_scan_chunked(a, b, cache["h"])
    y = torch.einsum("bsin,bsn->bsi", hs, c_ssm.float())
    y = (y.to(x.dtype) + x_c * p["d_skip"]) * F.silu(z)
    out = constrain(y @ p["out_proj"], "batch", "seq", "embed_act",
                    site="mamba.out_proj")
    new_cache = None
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(new_h)
        new_cache = cache
    return x + out, new_cache


def init_mamba_cache(cfg, batch, dtype, device):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
    }
