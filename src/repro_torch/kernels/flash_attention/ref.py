"""Plain PyTorch attention with the flash kernel's semantics: the port of
``repro.kernels.flash_attention.ref.attention_ref`` and the plain version of
kernel K3.

It differs from the JAX oracle in one place, on purpose: masked scores are
-1e30 and a row with no unmasked key gives 0, as the Pallas and the Hopper
kernel give, where the oracle's ``-inf`` gives NaN.  Queries go in chunks so
that the (B, H, chunk, Skv) scores stay bounded at long sequence lengths; each
row's softmax is independent, so chunking changes no value.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, chunk: int = 1024):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D).  f32 softmax, out in q's dtype.
    Positions count from 0 for q and k alike: ``kpos <= qpos`` when causal,
    and ``kpos > qpos - window`` when ``window > 0``."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    kt = k.to(torch.float32).permute(0, 2, 3, 1)[:, :, None]  # (B, KVH, 1, D, Skv)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]  # (B, KVH, 1, Skv, D)
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty((b, sq, h, v.shape[-1]), dtype=q.dtype, device=q.device)
    for s0 in range(0, sq, chunk):
        qc = q[:, s0:s0 + chunk].to(torch.float32)
        c = qc.shape[1]
        qg = qc.reshape(b, c, kvh, g, d).permute(0, 2, 3, 1, 4)  # (B, KVH, G, C, D)
        s = torch.matmul(qg, kt) * scale  # (B, KVH, G, C, Skv)
        qpos = torch.arange(s0, s0 + c, device=q.device)[:, None]
        mask = torch.ones((c, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window > 0:
            mask &= kpos[None, :] > qpos - window
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.where(l == 0, torch.ones_like(l), l)
        out[:, s0:s0 + c] = o.permute(0, 3, 1, 2, 4).reshape(b, c, h, -1).to(q.dtype)
    return out
