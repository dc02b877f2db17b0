"""PyTorch port of the exclusive-scan collectives, for one NVIDIA H100.

The p ranks of a scan sit on a leading rank axis of each payload
tensor; a schedule's rounds run as rank-axis permutations plus a masked
⊕ in hand-written CUDA round kernels (``kernels/csrc``).  The module
layout follows the JAX package ``repro`` so each piece has an obvious
counterpart.  Entry points run on the CUDA card unless ``device="cpu"``
is passed, which runs the kernels' plain PyTorch versions.
"""
