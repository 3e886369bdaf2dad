"""repro_torch — the PyTorch/CUDA port of the DIRC-RAG reproduction.

Grows beside the JAX package `repro`, which stays the reference. The
layout mirrors it (`configs`, `data`, `core`, `kernels`, `models`,
`serving`) so each counterpart is easy to find. This package imports
torch and numpy, never jax and nothing of `repro`. Entry points run on
the card unless the caller passes `device="cpu"`.
"""
__version__ = "1.0.0"
