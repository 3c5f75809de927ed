"""Paged attention: hand-written Hopper kernels (csrc/) and their plain
PyTorch versions (ref.py), dispatched by ops.py."""
from . import ops, ref

__all__ = ["ops", "ref"]
