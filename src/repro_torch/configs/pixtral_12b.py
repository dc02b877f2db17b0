"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409].

Mistral-Nemo backbone (head_dim 128); the pixtral ViT frontend is a
STUB per the assignment: input_specs provides precomputed patch
embeddings occupying the first ``n_prefix`` backbone positions.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1_000_000_000.0,
    frontend="vision",
    n_prefix=64,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    n_prefix=4,
    dtype="float32",
)
