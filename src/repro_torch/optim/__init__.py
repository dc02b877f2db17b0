"""Optimizers, and the optimizer-side scan consumers (top-k gradient
compression with error feedback, its compact offsets through the fused
exscan)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_lr,
    global_norm,
)
from repro_torch.optim.compression import (
    init_error_feedback,
    sparse_gradient_sync,
)
