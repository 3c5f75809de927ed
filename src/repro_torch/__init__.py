"""PyTorch/CUDA port of the repro serving stack.

A second package beside the JAX reference (`repro`): the paged, chunked,
batched serving path of a dense GQA decoder in eager PyTorch, with the two
paged attention kernels written by hand in CUDA C++ for Hopper (sm_90a).
It imports torch, numpy and the standard library only.  Entry points run
on "cuda" unless the caller passes device="cpu"; on a CPU tensor every
kernel wrapper takes its plain PyTorch version instead.
"""
