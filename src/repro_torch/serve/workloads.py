"""Request generators: the scan service's live traffic, drawn from the
real consumers (the JAX package's ``serve/workloads.py``).

Two request classes dominate the repo's small-m scan traffic, and both
generators here are wired to the code those consumers run:

  * **MoE dispatch** (``models/moe.py``): per step, per MoE layer, each
    rank exscans its per-expert dispatch counts AND allreduces the
    capacity totals — ONE fused scan_total of an (e_pad,)-int32 vector.
    :func:`moe_dispatch_payload` routes random tokens through the port's
    routing kernel (``kernels.ops.moe_routing``, all ranks in one
    launch), so the count vectors have the layer's real distribution,
    and :func:`moe_bucket` derives e_pad from the same
    ``models.params.experts_padded`` padding rule.

  * **Gradient-compression offsets** (``optim/compression.py``): the
    compact-layout offset per leaf group is an exclusive scan of a
    per-rank scalar slot count — k concurrent scalar exscans per sync.
    :func:`compression_offset_payloads` computes the counts with
    :func:`~repro_torch.optim.compression.leaf_slot_counts` (optionally
    jittered, the variable-count thresholding case).

For the same seed both generators give the JAX package's integers.
:func:`poisson_arrivals` builds an open-loop Poisson timeline.
"""

from __future__ import annotations

import numpy as np

from repro_torch import device as device_lib
from repro_torch.kernels import ops
from repro_torch.models import params as PD
from repro_torch.optim.compression import leaf_slot_counts
from repro_torch.serve.bucket import Bucket


# ---------------------------------------------------------------------------
# MoE dispatch-offset + capacity requests (models/moe.py traffic)
# ---------------------------------------------------------------------------


def moe_bucket(cfg, name: str = "") -> Bucket:
    """The bucket of one MoE layer's dispatch accounting: a scan_total
    (offsets fused with the capacity allreduce, exactly the
    ``scan_with_total`` call of ``models.moe.dispatch_slots``) of the
    padded per-expert count vector."""
    e_pad = PD.experts_padded(cfg)
    if not e_pad:
        raise ValueError("config has no experts (n_experts == 0)")
    return Bucket(kind="scan_total", monoid="add", shape=(e_pad,),
                  dtype=np.int32, name=name or "moe_dispatch")


def moe_dispatch_payload(cfg, p: int, rng: np.random.Generator,
                         n_tokens: int = 64, *, device=None) -> np.ndarray:
    """One request's payload: per-rank per-expert dispatch counts,
    (p, e_pad) int32 — each rank's top-k routing of ``n_tokens`` random
    tokens, counted by the routing kernel on ``device`` (the card when
    None) in one launch over the p ranks."""
    e_pad = PD.experts_padded(cfg)
    k = max(1, cfg.top_k)
    assignment = np.stack([
        rng.integers(0, max(cfg.n_experts, 1),
                     size=(n_tokens, k)).astype(np.int32)
        for _ in range(p)])
    _, counts = ops.moe_routing(assignment, e_pad, device=device)
    return device_lib.leaf_to_numpy(counts)


# ---------------------------------------------------------------------------
# Compression-offset requests (optim/compression.py traffic)
# ---------------------------------------------------------------------------


def compression_bucket(name: str = "") -> Bucket:
    """The bucket of one leaf group's compact-layout offset exscan: a
    per-rank scalar slot count (shape ``()``, int32)."""
    return Bucket(kind="exclusive", monoid="add", shape=(),
                  dtype=np.int32, name=name or "compression_offsets")


def compression_offset_payloads(
        p: int, leaf_sizes, k_fraction: float = 0.01, *,
        rng: np.random.Generator | None = None,
        thresholded: bool = False) -> list[np.ndarray]:
    """One gradient sync's offset-scan payloads: per leaf group, the
    (p,)-int32 per-rank slot counts — ``leaf_slot_counts`` of the
    compression module.  ``thresholded=True`` jitters each rank's count
    below the top-k budget (the threshold-crossing case where ranks
    genuinely differ and the exscan is load-bearing)."""
    counts = leaf_slot_counts(leaf_sizes, k_fraction)
    payloads = []
    for c in counts:
        per_rank = np.full((p,), c, dtype=np.int32)
        if thresholded:
            if rng is None:
                raise ValueError("thresholded counts need an rng")
            per_rank = rng.integers(1, c + 1, size=(p,)).astype(
                np.int32)
        payloads.append(per_rank)
    return payloads


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


def poisson_arrivals(rng: np.random.Generator, rate: float,
                     n: int) -> np.ndarray:
    """n open-loop Poisson arrival times at ``rate`` requests/second
    (exponential inter-arrivals, starting at the first gap)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    return np.cumsum(rng.exponential(1.0 / rate, size=n))
