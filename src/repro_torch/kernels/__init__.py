"""Hand-written Hopper kernels (csrc/: K1-K5 attention - serving and the
FA-2 forward / backward - and the K6 Mamba2 and K7 RWKV6 scans) and their
plain PyTorch versions (ref.py), dispatched by ops.py."""
from . import ops, ref

__all__ = ["ops", "ref"]
