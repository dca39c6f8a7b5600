"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The state mirrors the parameter tree (nested dicts of f32 tensors).  Where
JAX builds new trees, :func:`update` writes the new parameters and moments
into the given tensors, leaf by leaf: at full width a second f32 copy of
params, m and v would not fit beside them.  The values are those of JAX's
functional form, computed in its order: these are the plain elementwise
passes that JAX leaves to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models import nn


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any  # like params
    v: Any  # like params


def init(params: Any) -> AdamWState:
    device = nn.tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      nn.tree_map(torch.zeros_like, params),
                      nn.tree_map(torch.zeros_like, params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in nn.tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def _clip_leaf(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return nn.tree_map(lambda g: _clip_leaf(g, scale), grads), norm


@torch.no_grad()
def update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``params``, ``state.m`` and ``state.v`` are updated in
    place and returned; ``grads`` are read only."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t

    def upd(g, m, v, p):
        g32 = _clip_leaf(g, scale).to(torch.float32)
        # b1 * m + (1 - b1) * g32 with b1 * m fused into the add, as XLA
        # compiles it (and as add's alpha computes it on both devices): where
        # the two terms nearly cancel, rounding b1 * m first differs
        torch.add((1 - b1) * g32, m, alpha=b1, out=m)
        torch.add((1 - b2) * torch.square(g32), v, alpha=b2, out=v)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
        p.sub_(lr * delta)

    for g, m, v, p in zip(*map(nn.tree_leaves, (grads, state.m, state.v, params))):
        upd(g, m, v, p)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
