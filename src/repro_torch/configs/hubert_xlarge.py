"""HuBERT-XLarge [arXiv:2106.07447].

Encoder-only (bidirectional, no decode step); the CNN waveform
frontend is a STUB per the assignment: input_specs provides precomputed
frame embeddings; the head predicts 504 cluster targets.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    encoder_only=True,
    frontend="audio",
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=64,
    dtype="float32",
)
