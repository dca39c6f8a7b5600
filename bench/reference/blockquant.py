"""Plain per-128-block absmax int8 quantisation, frozen here: a copy of the
port's ``kernels/block_quant/ref.py`` (the semantics DaeMon's link states),
so that the reference depends on nothing of the port."""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, block: int = 128):
    """x: (..., C), C % block == 0 -> (int8 codes (..., C), f32 scales (..., C/block))."""
    shape = x.shape
    if shape[-1] % block:
        raise ValueError(f"last dim {shape[-1]} is not a multiple of block {block}")
    xb = x.to(torch.float32).reshape(*shape[:-1], shape[-1] // block, block)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = absmax / torch.full_like(absmax, 127.0)  # IEEE division, as the kernel
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xb / safe), -127, 127).to(torch.int8)
    return q.reshape(shape), scale[..., 0]


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """float32 values of the codes."""
    shape = q.shape
    qb = q.reshape(*shape[:-1], scales.shape[-1], -1).to(torch.float32)
    return (qb * scales[..., None]).reshape(shape)


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    """The float32 value that crosses the link: dequantize(quantize(x))."""
    return dequantize(*quantize(x))
