"""Training data: the deterministic synthetic pipeline."""
