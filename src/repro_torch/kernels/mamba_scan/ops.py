"""Public selective-scan entry point (port of
``repro.kernels.mamba_scan.ops``): the Hopper kernel K4 for CUDA tensors,
which raises on what it does not take; the plain version in ``ref.py`` for
CPU tensors, which the caller asked for."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.mamba_scan import kernel, ref


def selective_scan(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   x: torch.Tensor):
    """dt, x: (B, S, D); a: (D, N); bmat, cmat: (B, S, N) ->
    (y (B, S, D) f32, h_last (B, D, N) f32).  Forward only on the card, as
    the Pallas kernel is: a CUDA call that autograd would have to
    differentiate raises."""
    if dt.is_cuda:
        runtime.forward_only("selective_scan (K4)", dt, a, bmat, cmat, x)
        return kernel.forward(dt, a, bmat, cmat, x)
    return ref.selective_scan_ref(dt, a, bmat, cmat, x)
