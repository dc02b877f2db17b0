"""Granite-3.0-3B-A800M MoE [hf:ibm-granite].

40 routed experts, top-8, no shared experts.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    d_expert_ff=512,
    head_dim=64,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    d_expert_ff=64,
    vocab=256,
    n_experts=8,
    top_k=4,
    head_dim=12,
    dtype="float32",
)
