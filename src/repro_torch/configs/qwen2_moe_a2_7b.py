"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts (top-4) + 4 shared experts, every layer MoE.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,  # shared-expert path (4 x 1408)
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_expert_ff=1408,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    d_expert_ff=32,
    vocab=256,
    n_experts=8,
    top_k=2,
    n_shared_experts=2,
    dtype="float32",
)
