"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892].  Attention-free."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / 64 wkv heads
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,  # 2 wkv heads
    n_heads=2,
    n_kv_heads=2,
    d_ff=256,
    vocab=256,
    dtype="float32",
)
