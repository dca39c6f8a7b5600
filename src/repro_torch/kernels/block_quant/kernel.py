"""Launch wrappers of the Hopper block-quant kernels in ``csrc/block_quant.cu``:
K1 (``quantize``) and K2 (``dequantize``), on 2-D CUDA tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

BLOCK = 128

_SIGNATURES = {
    "bq_quantize": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_void_p],
    "bq_dequantize": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_void_p],
    "bq_quantize_launch": [ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)],
}
_FLOATS = (torch.float32, torch.bfloat16)


def _check_2d(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 2-D tensor, got shape {tuple(t.shape)}")
    if t.shape[1] % BLOCK:
        raise ValueError(f"{what}: last dim {t.shape[1]} is not a multiple of {BLOCK}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def quantize(x: torch.Tensor):
    """K1. x: (R, C) f32/bf16 -> (q int8 (R, C), scales f32 (R, C/128))."""
    _check_2d(x, "x")
    if x.dtype not in _FLOATS:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    r, c = x.shape
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scales = torch.empty((r, c // BLOCK), dtype=torch.float32, device=x.device)
    n_blocks = x.numel() // BLOCK
    if n_blocks:
        lib = runtime.load("block_quant", _SIGNATURES)
        with torch.cuda.device(x.device):
            err = lib.bq_quantize(
                x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(), scales.data_ptr(),
                n_blocks, torch.cuda.current_stream().cuda_stream,
            )
        runtime.check(lib, err, "block_quant.quantize")
        runtime.LAUNCHES["block_quant.quantize"] += 1
    return q, scales


def quantize_launch(n_blocks: int, x_dtype: torch.dtype = torch.float32) -> dict:
    """K1's launch for ``n_blocks`` blocks of ``x_dtype`` on the current card:
    grid, threads, shared memory and the CTAs an SM holds."""
    lib = runtime.load("block_quant", _SIGNATURES)
    return runtime.launch_config(lib, "bq_quantize_launch", "block_quant.quantize",
                                 int(x_dtype == torch.bfloat16), n_blocks)


def dequantize(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """K2. q int8 (R, C), scales f32 (R, C/128) -> (R, C) in ``dtype`` (f32/bf16)."""
    _check_2d(q, "q")
    if q.dtype != torch.int8:
        raise ValueError(f"q must be int8, got {q.dtype}")
    r, c = q.shape
    if scales.dtype != torch.float32 or tuple(scales.shape) != (r, c // BLOCK):
        raise ValueError(f"scales must be float32 of shape {(r, c // BLOCK)}")
    if scales.device != q.device or not scales.is_contiguous():
        raise ValueError("scales must be contiguous and on q's device")
    if dtype not in _FLOATS:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    out = torch.empty((r, c), dtype=dtype, device=q.device)
    n_blocks = q.numel() // BLOCK
    if n_blocks:
        lib = runtime.load("block_quant", _SIGNATURES)
        with torch.cuda.device(q.device):
            err = lib.bq_dequantize(
                q.data_ptr(), scales.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
                n_blocks, torch.cuda.current_stream().cuda_stream,
            )
        runtime.check(lib, err, "block_quant.dequantize")
        runtime.LAUNCHES["block_quant.dequantize"] += 1
    return out
