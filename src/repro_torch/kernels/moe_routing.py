"""MoE routing on the card: each (token, slot)'s position in its
expert's buffer, and the per-expert counts.

:func:`moe_routing` launches the CUDA kernel of ``csrc/moe_routing.cu``,
which replaces the Pallas ``moe_routing`` of the JAX package's
``kernels/moe_routing.py`` (body ``_routing_kernel``).  An assignment is
(T, K) int32 expert ids, or (G, T, K) for G groups routed apart in one
launch (on the stacked paths G is the rank).  Positions keep the
assignment's shape; counts are (G, E), so (1, E) for a (T, K)
assignment, as in the JAX package.

The kernel runs for CUDA tensors, or the call raises; the plain
PyTorch version (:func:`moe_routing_plain`, a one-hot cumsum) runs only
for CPU tensors.  ``moe_routing.launches`` counts the kernel's
launches.  Bound: bytes, 2·G·T·K·4 + G·E·4.  Ids outside [0, E) are
outside the contract: they are not counted and get position 0.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import scan_engine as se

_handle = None


def _lib():
    global _handle
    if _handle is None:
        from repro_torch.kernels import _build

        lib = _build.load("moe_routing")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mr_routing.argtypes = (vp, vp, vp, ll, ll, ll, ci, vp)
        lib.mr_routing.restype = ci
        _handle = lib
    return _handle


def _grouped(assignment: torch.Tensor) -> torch.Tensor:
    if assignment.dtype != torch.int32:
        raise TypeError(f"expert ids must be int32, got {assignment.dtype}")
    if assignment.dim() == 2:
        return assignment.unsqueeze(0)
    if assignment.dim() == 3:
        return assignment
    raise ValueError(f"assignment must be (T, K) or (G, T, K), got "
                     f"{tuple(assignment.shape)}")


def moe_routing_plain(assignment: torch.Tensor, *, num_experts: int):
    """The plain version of :func:`moe_routing`: a one-hot cumsum over
    the row-major (token, slot) order of each group."""
    g = _grouped(assignment)
    G = g.shape[0]
    flat = g.reshape(G, -1, 1)
    experts = torch.arange(num_experts, dtype=torch.int32,
                           device=g.device)
    onehot = (flat == experts).to(torch.int32)  # (G, T·K, E)
    excl = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    positions = (excl * onehot).sum(dim=2, dtype=torch.int32)
    counts = onehot.sum(dim=1, dtype=torch.int32)
    return positions.reshape(assignment.shape), counts


def moe_routing(assignment: torch.Tensor, *, num_experts: int):
    """Positions within the expert buffers, and per-expert counts."""
    if not assignment.is_cuda:
        return moe_routing_plain(assignment, num_experts=num_experts)
    g = _grouped(assignment)
    if not g.is_contiguous():
        raise ValueError("the assignment must be contiguous")
    G, T, K = g.shape
    positions = torch.empty_like(g)
    counts = torch.empty((G, num_experts), dtype=torch.int32,
                         device=g.device)
    rc = _lib().mr_routing(g.data_ptr(), positions.data_ptr(),
                           counts.data_ptr(), G, T, K, int(num_experts),
                           se._stream(g.device))
    if rc:
        raise RuntimeError(f"moe_routing kernel failed with code {rc}")
    moe_routing.launches += 1
    se._count_op(moe_routing, "routing")
    return positions.reshape(assignment.shape), counts


se.KERNELS["moe_routing"] = moe_routing
moe_routing.launches = 0
moe_routing.launches_by_op = {}
