"""The JAX package's ``examples/`` on the card: each a module with a
``main(argv=None) -> int``, run as ``python -m
repro_torch.examples.<name>`` (``--device cpu`` for the host)."""
