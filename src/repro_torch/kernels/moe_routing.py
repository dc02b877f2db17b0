"""MoE routing on the card: each (token, slot)'s position in its
expert's buffer, and the per-expert counts.

:func:`moe_routing` launches the CUDA kernel of ``csrc/moe_routing.cu``,
which replaces the Pallas ``moe_routing`` of the JAX package's
``kernels/moe_routing.py`` (body ``_routing_kernel``).  An assignment is
(T, K) int32 expert ids, or (G, T, K) for G groups routed apart in one
launch (on the stacked paths G is the rank).  Positions keep the
assignment's shape; counts are (G, E), so (1, E) for a (T, K)
assignment, as in the JAX package.

The kernel runs one thread-block cluster per group, of the size
:func:`routing_cluster` picks: its blocks split the group's entries and
exchange their histograms through distributed shared memory.  It runs
for CUDA tensors, or the call raises; the plain PyTorch version
(:func:`moe_routing_plain`, a one-hot cumsum) runs only for CPU
tensors; on meta tensors its meta rule (``scan_engine.meta_count``)
returns empty outputs.  ``moe_routing.launches`` counts the kernel's
launches.
Bound: bytes, 2·G·T·K·4 + G·E·4.  Ids outside [0, E) are outside the
contract: they are not counted and get position 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import scan_engine as se

CLUSTER_SIZES = (1, 2, 4, 8)  # the portable sizes
BLOCK_ENTRIES = 512  # the fewest entries a block of a cluster is given
_ERRORS = {10003: "too many experts for the kernel's shared tables",
           10004: "cluster size not in (1, 2, 4, 8)",
           10005: "the card cannot schedule a cluster of this size"}

_handle = None


def _lib():
    global _handle
    if _handle is None:
        from repro_torch.kernels import _build

        lib = _build.load("moe_routing")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mr_routing.argtypes = (vp, vp, vp, ll, ll, ll, ci, ci, vp)
        lib.mr_routing.restype = ci
        lib.mr_prepare.argtypes = (ci, ci)
        lib.mr_prepare.restype = ci
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


def routing_cluster(G: int, n: int, sms: int) -> int:
    """The cluster size CL for G groups of n entries on a card of
    ``sms`` SMs: the least power of two that gives the card two blocks
    per SM (G·CL >= 2·sms), as long as every block keeps at least
    ``BLOCK_ENTRIES`` entries and CL stays within ``CLUSTER_SIZES``.  A
    short group (n < 2·BLOCK_ENTRIES) takes CL = 1, the cluster-free
    instance."""
    cl = 1
    while (2 * cl <= CLUSTER_SIZES[-1] and G * cl < 2 * sms
           and n >= 2 * cl * BLOCK_ENTRIES):
        cl *= 2
    return cl


def _check(rc: int, num_experts: int, cluster: int) -> None:
    if rc:
        raise RuntimeError(f"moe_routing kernel failed with code {rc} "
                           f"{_ERRORS.get(rc, '')} (E = {num_experts}, "
                           f"cluster = {cluster})")


@functools.lru_cache(maxsize=256)
def _setup(index: int, G: int, n: int, num_experts: int,
           cluster: int | None) -> int:
    """The cluster size of a launch over G groups of n entries on card
    ``index`` (``cluster``, or :func:`routing_cluster`'s), with the card
    set up for it: the kernel's shared-memory limit and the cluster
    occupancy check, made once per key, so a call is one launch.  A
    failure is not cached: it raises again on the next call."""
    if cluster is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        cluster = routing_cluster(G, n, sms)
    with torch.cuda.device(index):
        _check(_lib().mr_prepare(num_experts, cluster), num_experts, cluster)
    return cluster


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


def moe_routing(assignment: torch.Tensor, *, num_experts: int,
                _cluster: int | None = None):
    """Positions within the expert buffers, and per-expert counts.
    ``_cluster`` forces a cluster size of ``CLUSTER_SIZES`` (the card
    tests and the per-size timings); None takes
    :func:`routing_cluster`'s."""
    if _cluster is not None and _cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}")
    if assignment.is_meta:  # the dry run's meta rule (scan_engine)
        g = _grouped(assignment)
        positions = torch.empty_like(assignment)
        counts = g.new_empty((g.shape[0], int(num_experts)))
        se.meta_count("moe_routing", se._nbytes_of(g),
                      se._nbytes_of(positions, counts))
        return positions, counts
    if not assignment.is_cuda:
        return moe_routing_plain(assignment, num_experts=num_experts)
    g = _grouped(assignment)
    if not g.is_contiguous():
        raise ValueError("the assignment must be contiguous")
    G, T, K = g.shape
    device, E = g.device, int(num_experts)
    cluster = _setup(device.index, G, T * K, E, _cluster)
    positions = torch.empty_like(g)
    counts = g.new_empty((G, E))
    rc = _lib().mr_routing(g.data_ptr(), positions.data_ptr(),
                           counts.data_ptr(), G, T, K, E, cluster,
                           se._stream(device))
    if rc:
        _check(rc, E, cluster)
    moe_routing.launches += 1
    se._count_op(moe_routing, "routing")
    return positions.reshape(assignment.shape), counts


se.KERNELS["moe_routing"] = moe_routing
moe_routing.launches = 0
moe_routing.launches_by_op = {}
