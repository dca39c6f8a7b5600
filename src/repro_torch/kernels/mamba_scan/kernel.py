"""Launch wrapper of the Hopper selective-scan kernel K4 in
``csrc/mamba_scan.cu``, on CUDA tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime

STATE_DIMS = (4, 8, 16)  # the kernel's template instances of N

_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {
    "ms_forward": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "ms_forward_launch": [_I, _I, _I, _I, ctypes.POINTER(_I)],
}


def _check(dt, a, bmat, cmat, x) -> None:
    for name, t in (("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat), ("x", x)):
        if not t.is_cuda or t.device != dt.device:
            raise ValueError(f"{name} must be a CUDA tensor on {dt.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.float32 and not (name == "x" and t.dtype == torch.bfloat16):
            raise ValueError(f"{name} must be float32{' or bfloat16' if name == 'x' else ''}, "
                             f"got {t.dtype}")
    if dt.dim() != 3:
        raise ValueError(f"dt must be (B, S, D), got shape {tuple(dt.shape)}")
    b, s, d = dt.shape
    if a.dim() != 2 or a.shape[0] != d:
        raise ValueError(f"a must be (D={d}, N), got shape {tuple(a.shape)}")
    n = a.shape[1]
    if n not in STATE_DIMS:
        raise ValueError(f"state dim N={n} not in the kernel's {STATE_DIMS}")
    if x.shape != dt.shape:
        raise ValueError(f"x {tuple(x.shape)} does not match dt {tuple(dt.shape)}")
    for name, t in (("bmat", bmat), ("cmat", cmat)):
        if tuple(t.shape) != (b, s, n):
            raise ValueError(f"{name} must be (B, S, N)={(b, s, n)}, got {tuple(t.shape)}")
    if b > 65535 or max(s, d) >= 2**31:  # grid.y is the batch; S and D are ints
        raise ValueError(f"shape {(b, s, d, n)} exceeds the kernel's launch range")


def forward(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
            x: torch.Tensor):
    """K4. dt (B, S, D) f32, a (D, N) f32, bmat/cmat (B, S, N) f32, x (B, S, D)
    f32 or bf16 -> (y (B, S, D) f32, h_last (B, D, N) f32)."""
    runtime.refuse_fake("mamba_scan.forward", dt, a, bmat, cmat, x)
    _check(dt, a, bmat, cmat, x)
    b, s, d = dt.shape
    n = a.shape[1]
    y = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    h_last = torch.zeros((b, d, n), dtype=torch.float32, device=dt.device)  # S == 0: h stays 0
    if y.numel() == 0:
        return y, h_last
    lib = runtime.load("mamba_scan", _SIGNATURES)
    with torch.cuda.device(dt.device), runtime.launching("mamba_scan.forward"):
        err = lib.ms_forward(
            dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), x.data_ptr(),
            int(x.dtype == torch.bfloat16), y.data_ptr(), h_last.data_ptr(), b, s, d, n,
            torch.cuda.current_stream().cuda_stream,
        )
    runtime.check(lib, err, "mamba_scan.forward")
    runtime.LAUNCHES["mamba_scan.forward"] += 1
    return y, h_last


def forward_launch(b: int, d: int, n: int, x_dtype: torch.dtype = torch.float32) -> dict:
    """K4's launch for (B, D, N) and x of ``x_dtype`` on the current card:
    grid, threads, shared memory and the CTAs an SM holds."""
    if n not in STATE_DIMS:
        raise ValueError(f"state dim N={n} not in the kernel's {STATE_DIMS}")
    lib = runtime.load("mamba_scan", _SIGNATURES)
    return runtime.launch_config(lib, "ms_forward_launch", "mamba_scan.forward",
                                 int(x_dtype == torch.bfloat16), b, d, n)
