"""The Mamba block's selective-SSM scan, from the JAX package's
``models/mamba.py``.

The JAX model walks ``SSM_CHUNK``-sized chunks with an outer
``lax.scan`` and solves each chunk with a log-depth associative scan.
Here the whole recurrence is one launch of the chunked-scan engine's
affine kernel: the batch is its group axis and the trailing state dims
(d_inner × d_state) its columns, so each column is walked once, in
order, with the state in a register.  The rest of ``mamba_block``
(projections, causal conv, gating) arrives with the model-stack slice.

Context parallelism: when the sequence is split over ranks, the carry
across ranks is the paper's exscan under the affine monoid
(``models/context_parallel.py``).
"""

from __future__ import annotations

import math

from repro_torch.kernels import scan_engine

# The JAX model's chunk length (its XLA scan's unit); the kernel walks
# the sequence in one pass and needs no chunking, so this only names
# the reference's value.
SSM_CHUNK = 64


def ssm_scan_chunked(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, S, ...);
    h0: (B, ...).

    Returns (h: (B, S, ...), h_final: (B, ...)).
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
