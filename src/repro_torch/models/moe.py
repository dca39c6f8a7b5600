"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing with
capacity-bounded dispatch, processed in token groups (bounded memory).

Dispatch is JAX's cumsum-rank scheme: every (token, k) assignment gets its
rank within its expert from a cumsum over a one-hot (Tg*K, E) matrix,
assignments ranked past the expert capacity C are dropped, and the expert
FFNs run as three batched products over (E, C, d).  JAX scatters with
``mode="drop"`` and gathers with ``mode="fill"``; here the flat (E*C, d)
dispatch buffer has one more row, the drop slot, which every dropped
assignment writes and which the expert products never see, and the gather
reads zeros there.  The scatter is out of place, so gradients reach ``x``
through it as through JAX's scatter-set.  Named ranges (``moe.route``,
``moe.dispatch``, ``moe.experts``) let a profile split the layer.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.nn import ParamSpec


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts_router")),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_down": ParamSpec((e, f, d), ("experts", None, "embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        specs.update(
            shared_gate=ParamSpec((d, fs), ("embed", "mlp")),
            shared_up=ParamSpec((d, fs), ("embed", "mlp")),
            shared_down=ParamSpec((fs, d), ("mlp", "embed")),
        )
    return specs


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def n_groups(tokens: int, cfg: ModelConfig) -> int:
    """Dispatch groups of ``tokens`` tokens: about one per ``moe_group_size``,
    the largest count at most that which divides ``tokens``."""
    g = max(1, tokens // max(cfg.moe_group_size, 1))
    while tokens % g:
        g -= 1
    return g


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: values in descending order, the
    lower index first on a tie (a stable descending sort; ``torch.topk``
    leaves the order of ties unspecified, and the order decides which
    assignments the capacity drops)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    gates: torch.Tensor  # (Tg, K) f32, renormalised
    idx: torch.Tensor  # (Tg, K) expert of each assignment
    pos: torch.Tensor  # (Tg*K,) rank within its expert, ``cap`` where dropped
    keep: torch.Tensor  # (Tg*K,) bool
    aux: torch.Tensor  # Switch load-balance loss, f32 scalar
    cap: int


def route(p, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router of one group, x: (Tg, d): f32 probabilities, top-k, gates,
    the aux loss E·Σ_e f_e·P_e, and each assignment's rank within its expert
    over the flattened (token, k) order."""
    tg = x.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = _capacity(tg, cfg)
    logits = torch.matmul(x.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)  # (Tg, E) f32
    gates, idx = top_k(probs, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    onehot = F.one_hot(idx.reshape(-1), e)  # (Tg*K, E)
    f_e = onehot.reshape(tg, k, e).sum(dim=1).to(torch.float32).mean(dim=0)
    aux = e * (f_e * probs.mean(dim=0)).sum()

    pos_in_e = torch.cumsum(onehot, dim=0) - 1  # rank of each assignment
    pos = torch.gather(pos_in_e, 1, idx.reshape(-1, 1))[:, 0]
    keep = pos < cap
    return Routing(gates, idx, torch.where(keep, pos, cap), keep, aux, cap)


def _dispatch_group(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Tg, d) -> (y: (Tg, d), aux_loss: scalar)."""
    tg, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    with record_function("moe.route"):
        r = route(p, x, cfg)
    cap = r.cap
    with record_function("moe.dispatch"):
        e_flat = r.idx.reshape(-1)
        tok_flat = torch.arange(tg, device=x.device).repeat_interleave(k)
        slot = torch.where(r.keep, e_flat * cap + r.pos, e * cap)  # e * cap: the drop slot
        xs = x.new_zeros((e * cap + 1, d)).index_put((slot,), x[tok_flat])
        xs = xs[:e * cap].view(e, cap, d)
        # keep the scattered dispatch buffer replicated: the expert products
        # below induce the expert sharding
        xs = nn.logical_constraint(xs, None, None, None)
    with record_function("moe.experts"):
        xg = torch.bmm(xs, p["w_gate"].to(x.dtype))
        xu = torch.bmm(xs, p["w_up"].to(x.dtype))
        ys = torch.bmm(nn.silu(xg) * xu, p["w_down"].to(x.dtype))
    with record_function("moe.dispatch"):
        y_tok = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))])[slot]  # (Tg*K, d)
        y_tok = y_tok * (r.gates.reshape(-1).to(x.dtype) * r.keep.to(x.dtype))[:, None]
        # jnp.sum over bf16 accumulates in f32
        y = y_tok.reshape(tg, k, d).to(torch.float32).sum(dim=1).to(x.dtype)
    return y, r.aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Token groups bound dispatch memory;
    where JAX scans the groups, the port loops over them."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    g = n_groups(xf.shape[0], cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for xi in xf.reshape(g, -1, d).unbind(0):
        yi, aux = _dispatch_group(p, xi, cfg)
        aux_total = aux_total + aux
        ys.append(yi)
    y = torch.cat(ys).reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + nn.swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    return y, aux_total / g
