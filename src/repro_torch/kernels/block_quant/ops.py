"""Public block-quantization entry points (port of
``repro.kernels.block_quant.ops``).

Any shape flattens to 2-D (rows, C) and quantizes per block along the last
axis.  A CUDA tensor goes to the Hopper kernel (K1/K2), which takes only
``block == 128``; anything else it raises on.  A CPU tensor, which the caller
asked for, takes the plain version in ``ref.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.block_quant import kernel, ref
from repro_torch.kernels.block_quant.kernel import BLOCK


def quantize(x: torch.Tensor, block: int = BLOCK):
    """x: (..., C) -> (q int8 (..., C), scales f32 (..., C/block))."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x2.is_cuda:
        if block != BLOCK:
            raise ValueError(f"the CUDA kernel quantizes {BLOCK}-element blocks, got {block}")
        q, s = kernel.quantize(x2.contiguous())
    else:
        q, s = ref.quantize_ref(x2, block)
    return q.reshape(shape), s.reshape(*shape[:-1], shape[-1] // block)


def dequantize(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    shape = q.shape
    q2 = q.reshape(-1, shape[-1])
    s2 = scales.reshape(q2.shape[0], -1)
    if q2.is_cuda:
        if q2.shape[-1] != s2.shape[-1] * BLOCK:
            raise ValueError(f"the CUDA kernel dequantizes {BLOCK}-element blocks")
        x = kernel.dequantize(q2.contiguous(), s2.contiguous(), dtype)
    else:
        x = ref.dequantize_ref(q2, s2, dtype)
    return x.reshape(shape)


def wire_bytes(shape, dtype_bytes: int = 2, block: int = BLOCK) -> int:
    """Compressed wire size: int8 payload + f32 scale per block."""
    n = int(np.prod(shape))
    return n + 4 * (n // block)
