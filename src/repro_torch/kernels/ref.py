"""Plain tensor oracles of the kernels' functions, as the JAX package's
``kernels/ref.py`` states them.

They are what the tests hold the kernels' entry points against; they
are not the kernels' plain versions (those sit beside each kernel and
repeat its order of operations).
"""

from __future__ import annotations

import torch


def exscan_ref(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Exclusive prefix sum along ``axis`` (row 0 gets zeros)."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype) - x


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor | None = None):
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t.

    a, b: (T, D).  h0: (D,) initial state (zeros if None).
    Returns (h, h_final) where h[t] is the state AFTER absorbing step t.
    """
    h = (torch.zeros(b.shape[1:], dtype=b.dtype, device=b.device)
         if h0 is None else h0.to(b.dtype))
    hs = []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return (torch.stack(hs) if hs else torch.empty_like(b)), h


def moe_routing_ref(assignment: torch.Tensor, num_experts: int):
    """Per-(token, slot) position within its expert + per-expert counts.

    assignment: (T, K) int32 expert ids in [0, num_experts), ordered
    row-major over (token, slot).  Returns positions (T, K) int32 (the
    exclusive count of earlier same-expert entries) and counts
    (num_experts,) int32.
    """
    flat = assignment.reshape(-1).long()
    onehot = torch.nn.functional.one_hot(flat, num_experts).to(torch.int32)
    excl = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    positions = excl.gather(1, flat[:, None])[:, 0]
    counts = onehot.sum(dim=0, dtype=torch.int32)
    return positions.reshape(assignment.shape), counts
