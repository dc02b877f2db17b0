"""Chunked diagonal-SSM scan: the chunked-scan engine's affine
instance, named as in the JAX package (``kernels/ssm_chunk_scan.py``)
so a reader finds the counterpart.

``h_t = a_t * h_{t-1} + b_t`` along the row axis is the per-rank local
half of the context-parallel SSM; the cross-rank half composes the
ranks' (A_total, B_total) summaries with the paper's exscan under the
affine monoid (``models/context_parallel.py``).
"""

from __future__ import annotations

from repro_torch.kernels.scan_engine import (affine_chunk_scan,
                                             affine_chunk_summary)

__all__ = ["ssm_chunk_scan", "ssm_chunk_summary"]


def ssm_chunk_scan(a, b, h0):
    """Solve h_t = a_t * h_{t-1} + b_t along the row axis.

    a, b: (T, D) or (G, T, D); h0: (1, D) or (G, D).
    Returns h (same shape as a) and h_final (G, D).
    """
    return affine_chunk_scan(a, b, h0)


def ssm_chunk_summary(a, b):
    """The slice's summary (A_total, B_total), each (G, D):
    h_out = A_total * h_in + B_total, the payload of the cross-rank
    exscan (affine monoid)."""
    return affine_chunk_summary(a, b)
