"""Plain PyTorch per-block absmax int8 quantization (link compression): the
port of ``repro.kernels.block_quant.ref`` and the plain version of kernels K1/K2.

Blocks are contiguous runs of ``block`` elements along the last axis; each
block gets one f32 scale (absmax / 127).  Wire format = int8 payload + f32
scales: 4096 B bf16 -> 2048 + 64 B  (~1.94x reduction incl. scales).
"""
from __future__ import annotations

import torch


def quantize_ref(x: torch.Tensor, block: int = 128):
    """x: (..., C) with C % block == 0 -> (q int8 (..., C), scales f32 (..., C/block))."""
    orig_shape = x.shape
    c = orig_shape[-1]
    if c % block:
        raise ValueError(f"last dim {c} is not a multiple of block {block}")
    xb = x.to(torch.float32).reshape(*orig_shape[:-1], c // block, block)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch divides by a Python scalar through its
    # reciprocal on CUDA, one ulp off the IEEE quotient the kernel computes
    scale = absmax / torch.full_like(absmax, 127.0)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xb / safe), -127, 127).to(torch.int8)
    return q.reshape(orig_shape), scale[..., 0]


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32):
    """Inverse of quantize_ref."""
    orig_shape = q.shape
    c = orig_shape[-1]
    block = c // scales.shape[-1]
    qb = q.reshape(*orig_shape[:-1], scales.shape[-1], block).to(torch.float32)
    x = qb * scales[..., None]
    return x.reshape(orig_shape).to(dtype)
