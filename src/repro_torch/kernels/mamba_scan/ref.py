"""Plain PyTorch selective scan: the port of
``repro.kernels.mamba_scan.ref.selective_scan_ref`` and the plain version of
kernel K4.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      h: (B, D, N), h_{-1} = 0
    y_t = sum_n h_t[..., n] * C_t[n]

It differs from the JAX oracle in one place, on purpose: it loops over the
sequence and carries only the (B, D, N) state, where the oracle materialises
``exp(dt * A)`` and ``dt * x * B`` for the whole sequence at once; at the
serving shape of falcon-mamba-7b that (B, S, D, N) tensor would take 8.6 GB.
The arithmetic per step is the oracle's.
"""
from __future__ import annotations

import torch


def selective_scan_ref(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, x: torch.Tensor):
    """dt: (B, S, D) f32; a: (D, N) (negative); bmat, cmat: (B, S, N); x: (B, S, D).
    Returns y: (B, S, D) f32, h_last: (B, D, N) f32."""
    b, s, d = dt.shape
    n = a.shape[1]
    dt = dt.to(torch.float32)
    a = a.to(torch.float32)
    dtx = dt * x.to(torch.float32)
    bmat, cmat = bmat.to(torch.float32), cmat.to(torch.float32)
    h = torch.zeros((b, d, n), dtype=torch.float32, device=dt.device)
    y = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)  # (B, D, N)
        h = da * h + dtx[:, t, :, None] * bmat[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, cmat[:, t])
    return y, h
