"""Logical-axis sharding of the port's tensors over a rank grid: the rule
tables (``rules``) and the activation context (``ctx``)."""
