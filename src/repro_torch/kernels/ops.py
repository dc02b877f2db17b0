"""Public entry points of the port's kernels, as the JAX package's
``kernels/ops.py`` names them.

Each takes tensors (or arrays, converted) and runs on ``device``: the
CUDA card when None, where the kernels launch, or ``device="cpu"``,
where their plain PyTorch versions run.  The JAX wrappers pad lanes and
rows to the TPU's (8, 128) tiles and size blocks by a VMEM budget; the
CUDA kernels bound-check their ragged edges instead, so nothing here
pads.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import moe_routing as _moe
from repro_torch.kernels import scan_engine as _se


def _on(x, dev: torch.device) -> torch.Tensor:
    t = device_lib.leaf_to_torch(x, dev)
    return t if t.is_contiguous() else t.contiguous()


def exscan(x, *, device=None) -> torch.Tensor:
    """Exclusive prefix sum along axis 0 of an (n, d) or (n,) array."""
    x = _on(x, device_lib.resolve(device))
    if x.dim() == 1:
        return _se.monoid_exscan(x[:, None], "add")[:, 0]
    return _se.monoid_exscan(x, "add")


def ssm_scan(a, b, h0=None, *, device=None):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t, axis 0.

    a, b: (T, D); h0: (D,) or None.  Returns (h: (T, D), h_final: (D,)).
    """
    dev = device_lib.resolve(device)
    a, b = _on(a, dev), _on(b, dev)
    h0 = None if h0 is None else _on(h0, dev).reshape(1, -1)
    _, h, _, h_fin = _se.affine_chunk(a, b, h0=h0, h_final=True)
    return h, h_fin[0]


def ssm_chunk_summary(a, b, *, device=None):
    """Chunk summary (A_total, B_total), each (D,), of a sequence slice:
    the affine monoid element composed across ranks by the exscan."""
    dev = device_lib.resolve(device)
    a_tot, b_tot = _se.affine_chunk_summary(_on(a, dev), _on(b, dev))
    return a_tot[0], b_tot[0]


def moe_routing(assignment, num_experts: int, *, device=None):
    """Write positions within expert buffers + per-expert counts.

    assignment: (T, K) int32.  Returns (positions (T, K) i32, counts
    (E,) i32).  A (G, T, K) assignment routes G groups apart in one
    launch and returns counts (G, E).
    """
    x = _on(assignment, device_lib.resolve(device))
    pos, counts = _moe.moe_routing(x, num_experts=num_experts)
    return pos, (counts[0] if x.dim() == 2 else counts)
