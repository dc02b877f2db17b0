"""Optimizer-side scan consumers (compression slot accounting)."""
