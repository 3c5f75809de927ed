"""PyTorch/CUDA port of the repro serving and training stack.

A second package beside the JAX reference (`repro`): serving a dense GQA
decoder (paged + chunked + batched, or monolithic prefill on the dense or
the paged KV cache) and training it (Trainer, AdamW, checkpoints; on one
device or a (data, model) DeviceMesh) in eager PyTorch, with the
attention kernels written by hand in CUDA C++ for Hopper (sm_90a;
csrc/).  It imports torch, numpy and the standard library
only.  Entry points run
on "cuda" unless the caller passes device="cpu"; on a CPU tensor every
kernel wrapper takes its plain PyTorch version instead.
"""
