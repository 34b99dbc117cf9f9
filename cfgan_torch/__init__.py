"""PyTorch/CUDA port of cfgan for NVIDIA Hopper (H100).

The JAX package `cfgan/` is the reference; this package mirrors its module
layout and keeps its NHWC activation layout so the two can be compared
tensor for tensor.  It imports torch, numpy and the standard library only.
Entry points run on the CUDA card unless the caller passes
`device="cpu"`; on the CPU every hand-written kernel is replaced by its
plain PyTorch version.
"""

__version__ = "0.1.0"
