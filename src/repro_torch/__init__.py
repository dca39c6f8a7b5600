"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Mirrors ``src/repro/`` module by module and imports nothing of it (nor of
JAX).  Plain tensor code is PyTorch; every Pallas kernel on a ported path is a
hand-written Hopper kernel under ``kernels/<name>/csrc``, built with ``nvcc``
at its first launch.  Entry points run on the card unless the caller passes
``device="cpu"``, where each kernel wrapper takes its plain PyTorch version.
"""
