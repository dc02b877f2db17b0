"""Jamba-1.5-Large (398B total / ~94B active) [arXiv:2403.19887].

Hybrid: 1 attention layer per 8 (1:7 attn:mamba), MoE (16 experts,
top-2) on every second layer.  Pattern unit = 8 layers, 9 repeats.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    d_expert_ff=24576,
    attn_period=8,
    d_state=16,
    d_conv=4,
    expand=2,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    d_expert_ff=128,
    vocab=256,
    n_experts=4,
    top_k=2,
    dtype="float32",
)
