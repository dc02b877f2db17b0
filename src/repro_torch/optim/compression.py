"""Slot accounting of top-k gradient compression, from the JAX
package's ``optim/compression.py``.  The sparse gradient sync itself
(top-k, error feedback, the fused offset exscans) is not ported yet."""

from __future__ import annotations


def leaf_slot_counts(sizes, k_fraction: float) -> list[int]:
    """Per-leaf compact slot counts: the top-k budget each rank
    contributes to leaf group i is ``max(1, int(sizes[i] *
    k_fraction))``.  The serve subsystem's compression request generator
    (``repro_torch.serve.workloads``) draws its traffic from it."""
    return [max(1, int(int(n) * k_fraction)) for n in sizes]
