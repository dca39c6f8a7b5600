"""Public flash-attention entry point (port of
``repro.kernels.flash_attention.ops``): the Hopper kernel K3 for CUDA
tensors, which raises on what it does not take; the plain version in
``ref.py`` for CPU tensors, which the caller asked for."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in q's dtype.
    Forward only on the card, as the Pallas kernel is: a CUDA call that
    autograd would have to differentiate raises (training attends through
    ``models.nn.attention``)."""
    if q.is_cuda:
        runtime.forward_only("flash_attention (K3)", q, k, v)
        return kernel.forward(q, k, v, causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)
