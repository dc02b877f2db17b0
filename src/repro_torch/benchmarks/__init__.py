"""Benchmark CLIs of the port (``python -m repro_torch.benchmarks.<name>``)."""
