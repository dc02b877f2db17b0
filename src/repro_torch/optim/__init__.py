"""Optimizers, and the optimizer-side scan consumers (compression slot
accounting)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_lr,
    global_norm,
)
