"""Shared layer primitives, from the JAX package's ``models/common.py``.

Casts follow the reference: ``rmsnorm`` and ``rope`` compute in fp32
and return ``x``'s dtype; the projections keep their operands' dtype.
``swiglu`` pins its products' logical axes where the reference does
(``sharding.ctx.constrain``, which returns its argument).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.ctx import constrain


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            dsl=None) -> torch.Tensor:
    """RMS norm over d.  With ``dsl`` (``models.shards.DSlices`` of more
    than one slice: decode_ws's d over "data") x holds the activations'
    d as ``dsl`` says: the sum of squares is taken slice by slice and
    summed over the slices (``dsl.sum_sq``), the mean over the whole
    d_model, and the scale is the slice's."""
    x32 = x.float()
    if dsl is None or dsl.n == 1:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        var = dsl.sum_sq(x32) / float(scale.shape[-1])
        scale = dsl.chan(scale)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, hd); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, dsl=None) -> torch.Tensor:
    """SwiGLU FFN.  With ``dsl`` (decode_ws's d over "data") the gate's
    and up's partials from the d-slice are summed in one reduction
    (``dsl.dots``) and down writes the slice (``dsl.out``)."""
    if dsl is not None and dsl.n > 1:
        g, u = dsl.dots([(x, w_gate), (x, w_up)])
        return dsl.out(F.silu(g) * u, w_down)
    g = F.silu(constrain(x @ w_gate, "batch", "seq", "mlp",
                         site="ffn.w_gate"))
    u = constrain(x @ w_up, "batch", "seq", "mlp", site="ffn.w_up")
    return constrain((g * u) @ w_down, "batch", "seq", "embed_act",
                     site="ffn.w_down")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def token_shift(x: torch.Tensor, prev: torch.Tensor | None = None):
    """RWKV token shift: x_{t-1} along the seq axis.  x: (B, S, D).
    ``prev``: (B, 1, D) carry-in from the previous chunk/step."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)
