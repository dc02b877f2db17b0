"""Padding rules of the parameter layout, from the JAX package's
``models/params.py``.  The parameter tables themselves (init, shapes,
sharding axes, counts) arrive with the model-stack slice of the port.
"""

from __future__ import annotations

import math

from repro_torch.models.config import ModelConfig


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def experts_padded(cfg: ModelConfig) -> int:
    """Pad expert count to a multiple of 16 (the TP/EP degree) so the
    expert dim shards; padded experts are masked off in the router."""
    return round_up(cfg.n_experts, 16) if cfg.n_experts else 0


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))
