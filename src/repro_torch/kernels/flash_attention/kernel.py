"""Launch wrapper of the Hopper flash-attention kernel K3 in
``csrc/flash_attention.cu``, on CUDA tensors: bf16 goes to the tensor-core
(wgmma + TMA) kernel, f32 to the CUDA-core one."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import runtime

HEAD_DIMS = (16, 32, 64, 80, 128, 160)  # the kernels' template instances

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_SIGNATURES = {
    "fa_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, ctypes.c_float, _P],
    "fa_forward_bf16_launch": [_I, _I, _I, _I, ctypes.POINTER(_I)],
}


def layout_error(name: str, shape, strides, dtype: torch.dtype, data_ptr: int) -> Optional[str]:
    """Why the kernel cannot read a (B, S, heads, D) operand laid out so, or
    None.  D must be contiguous.  bf16 goes through TMA, which needs 16-byte
    aligned rows: the other strides a multiple of 8 elements.  f32 is read
    with 16-byte vector loads of 4 elements: strides a multiple of 4.  Either
    way the base is 16-byte aligned."""
    if len(shape) != 4:
        return f"{name} must be (B, S, heads, D), got shape {tuple(shape)}"
    step = 8 if dtype == torch.bfloat16 else 4
    if strides[3] != 1 or any(s % step for s in strides[:3]) or data_ptr % 16:
        return (f"{name} needs unit stride on D, other strides a multiple of {step} elements, "
                f"and 16-byte alignment; got strides {tuple(strides)}")
    return None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"q, k, v must share dtype float32 or bfloat16, got {t.dtype}")
        err = layout_error(name, t.shape, t.stride(), t.dtype, t.data_ptr())
        if err:
            raise ValueError(err)
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"heads {h} are not a multiple of kv heads {k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {HEAD_DIMS}")


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            window: int) -> torch.Tensor:
    """K3. q (B, Sq, H, D), k/v (B, Skv, KVH, D) -> o (B, Sq, H, D) in q's dtype."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = runtime.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
            b, sq, skv, h, kvh, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window), 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream,
        )
    runtime.check(lib, err, "flash_attention.forward")
    runtime.LAUNCHES["flash_attention.forward"] += 1
    return o


def forward_bf16_launch(b: int, sq: int, h: int, d: int) -> dict:
    """K3's bf16 (wgmma + TMA) launch for q (B, Sq, H, D) on the current card:
    grid, threads, shared memory and the CTAs an SM holds."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {HEAD_DIMS}")
    lib = runtime.load("flash_attention", _SIGNATURES)
    return runtime.launch_config(lib, "fa_forward_bf16_launch", "flash_attention.forward",
                                 b, sq, h, d)
