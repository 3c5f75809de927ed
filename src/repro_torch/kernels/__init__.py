"""Attention: hand-written Hopper kernels (csrc/: K1-K5, serving and the
FA-2 forward / backward) and their plain PyTorch versions (ref.py),
dispatched by ops.py."""
from . import ops, ref

__all__ = ["ops", "ref"]
