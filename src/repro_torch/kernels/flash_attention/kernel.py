"""Launch wrappers of the Hopper flash-attention kernels, on CUDA tensors:
K3 in ``csrc/flash_attention.cu`` (bf16 to the tensor-core, wgmma + TMA,
kernel, f32 to the CUDA-core one; and its bf16 training instance, which also
stores each row's log-sum-exp), and K5, the training backward, in
``csrc/flash_attention_bwd.cu``."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import runtime

HEAD_DIMS = (16, 32, 64, 80, 128, 160)  # the kernels' template instances
TRAIN_HEAD_DIMS = (64, 80, 128)  # the training forward's and K5's instances

_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_SIGNATURES = {
    "fa_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, ctypes.c_float, _P],
    "fa_forward_bf16_launch": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "fa_train_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, ctypes.c_float, _P],
}
_BWD_ARGS = [_P] * 10 + [_I] * 6 + [ctypes.POINTER(_L), _I, _I, ctypes.c_float, _P]
_BWD_SIGNATURES = {"fa_backward_dq": _BWD_ARGS, "fa_backward_dkdv": _BWD_ARGS}


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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           head_dims=HEAD_DIMS, **more: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
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
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in the kernel's {head_dims}")


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            window: int) -> torch.Tensor:
    """K3. q (B, Sq, H, D), k/v (B, Skv, KVH, D) -> o (B, Sq, H, D) in q's dtype."""
    runtime.refuse_fake("flash_attention.forward", q, k, v)
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = runtime.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device), runtime.launching("flash_attention.forward"):
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


def _train_libs():
    """K3's and K5's libraries, both built (in parallel) on first use."""
    return runtime.load_together({"flash_attention": _SIGNATURES,
                                  "flash_attention_bwd": _BWD_SIGNATURES})


def train_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  window: int):
    """K3's bf16 training instance: q (B, Sq, H, D), k/v (B, Skv, KVH, D) ->
    o (B, Sq, H, D) bf16 and lse (B, H, Sq) f32, each row's log-sum-exp of
    its scaled, masked scores (+inf where a row sees no key)."""
    runtime.refuse_fake("flash_attention.train_forward", q, k, v)
    _check(q, k, v, TRAIN_HEAD_DIMS)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the training forward takes bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if skv == 0:
        raise ValueError("the training forward needs at least one key")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib, _ = _train_libs()
    with torch.cuda.device(q.device), runtime.launching("flash_attention.train_forward"):
        err = lib.fa_train_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, sq, skv, h, kvh, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window), 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream,
        )
    runtime.check(lib, err, "flash_attention.train_forward")
    runtime.LAUNCHES["flash_attention.train_forward"] += 1
    return o, lse


def _bwd_args(q, k, v, o, do, lse, delta, dq, dk, dv, causal: bool, window: int):
    """The arguments of K5's launchers (``fa_backward_dq``, ``fa_backward_dkdv``;
    a tensor a launcher does not touch may be None)."""
    b, sq, h, d = q.shape
    ptr = lambda t: 0 if t is None else t.data_ptr()
    strides = (_L * 15)(*(s for t in (q, k, v, o if o is not None else q, do)
                          for s in t.stride()[:3]))
    return (ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(delta), ptr(dq), ptr(dk),
            ptr(dv), b, sq, k.shape[1], h, k.shape[2], d, strides, int(causal), int(window),
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)


def _check_bwd(q, k, v, lse, **more) -> None:
    _check(q, k, v, TRAIN_HEAD_DIMS, **more)
    b, sq, h, _ = q.shape
    if q.dtype != torch.bfloat16 or any(t.shape != q.shape for t in more.values()):
        raise ValueError(f"K5 takes bfloat16 q and q-shaped {sorted(more)}, got {q.dtype}, "
                         f"{[tuple(t.shape) for t in more.values()]}")
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, sq)}")


def backward_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                lse: torch.Tensor, do: torch.Tensor, *, causal: bool, window: int):
    """K5's first kernel: dq (B, Sq, H, D) bf16 of the attention whose training
    forward gave o and lse, for the output's gradient ``do``, and delta (B, H,
    Sq) f32 = sum(do * o) over each row, which the second kernel reads."""
    runtime.refuse_fake("flash_attention_bwd.dq", q, k, v, o, lse, do)
    _check_bwd(q, k, v, lse, o=o, do=do)
    b, sq, h, _ = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    _, lib = _train_libs()
    args = _bwd_args(q, k, v, o, do, lse, delta, dq, None, None, causal, window)
    with torch.cuda.device(q.device), runtime.launching("flash_attention_bwd.dq"):
        err = lib.fa_backward_dq(*args)
    runtime.check(lib, err, "flash_attention_bwd.dq")
    runtime.LAUNCHES["flash_attention_bwd.dq"] += 1
    return dq, delta


def backward_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, window: int):
    """K5's second kernel: dk and dv (B, Skv, KVH, D) bf16, each key's sums
    over every q head of its group, from the forward's lse and the first
    kernel's delta."""
    runtime.refuse_fake("flash_attention_bwd.dkdv", q, k, v, do, lse, delta)
    _check_bwd(q, k, v, lse, do=do)
    if delta.dtype != torch.float32 or delta.shape != lse.shape or not delta.is_contiguous():
        raise ValueError(f"delta must be contiguous float32 {tuple(lse.shape)}")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    _, lib = _train_libs()
    args = _bwd_args(q, k, v, None, do, lse, delta, None, dk, dv, causal, window)
    with torch.cuda.device(q.device), runtime.launching("flash_attention_bwd.dkdv"):
        err = lib.fa_backward_dkdv(*args)
    runtime.check(lib, err, "flash_attention_bwd.dkdv")
    runtime.LAUNCHES["flash_attention_bwd.dkdv"] += 1
    return dk, dv
