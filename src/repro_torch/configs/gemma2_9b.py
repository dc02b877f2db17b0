"""Gemma-2-9B [arXiv:2408.00118].

Local(4096-window)/global alternation, attention-score softcap 50,
final-logit softcap 30, tied embeddings, head_dim 256.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    sliding_window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    sliding_window=32,
    dtype="float32",
)
