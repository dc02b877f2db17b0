"""Rank-local exclusive prefix sum: the chunked-scan engine's add
instance, named as in the JAX package (``kernels/blelloch_exscan.py``)
so a reader finds the counterpart.  The engine serves any elementwise
monoid (``scan_engine.monoid_exscan``)."""

from __future__ import annotations

from repro_torch.kernels.scan_engine import block_combine, monoid_exscan

__all__ = ["block_combine", "blelloch_exscan"]


def blelloch_exscan(x):
    """Exclusive prefix sum over the row axis of (n, d) or (G, n, d)."""
    return monoid_exscan(x, "add")
