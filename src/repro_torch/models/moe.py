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

from typing import Callable, Dict, NamedTuple, Tuple

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
    logits = nn.dense(x.to(torch.float32), p["router"])
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


def _experts(p, xs: torch.Tensor) -> torch.Tensor:
    """The expert FFNs over the dispatch buffer xs (E, C, d) -> (E, C, d)."""
    xg = torch.bmm(xs, p["w_gate"].to(xs.dtype))
    xu = torch.bmm(xs, p["w_up"].to(xs.dtype))
    return torch.bmm(nn.silu(xg) * xu, p["w_down"].to(xs.dtype))


def _dispatch_group(p, x: torch.Tensor, cfg: ModelConfig,
                    experts: Callable = _experts) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Tg, d) -> (y: (Tg, d), aux_loss: scalar).  ``experts(p, xs)`` maps
    the dispatch buffer xs (E, C, d) to the experts' outputs."""
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
    with record_function("moe.experts"):
        ys = experts(p, xs)
    with record_function("moe.dispatch"):
        y_tok = torch.cat([ys.reshape(e * cap, d), ys.new_zeros((1, d))])[slot]  # (Tg*K, d)
        y_tok = y_tok * (r.gates.reshape(-1).to(x.dtype) * r.keep.to(x.dtype))[:, None]
        # jnp.sum over bf16 accumulates in f32
        y = y_tok.reshape(tg, k, d).to(torch.float32).sum(dim=1).to(x.dtype)
    return y, r.aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Token groups bound dispatch memory;
    where JAX scans the groups, the port loops over them.  A DTensor ``x``
    dispatches on local blocks (:func:`_apply_moe_sharded`)."""
    if nn.is_dtensor(x):
        return _apply_moe_sharded(p, x, cfg)
    y, aux = _routed(p, x, cfg)
    if cfg.num_shared_experts:
        y = y + nn.swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    return y, aux


def _routed(p, x: torch.Tensor, cfg: ModelConfig, experts: Callable = _experts):
    """The routed experts over x (B, S, d) in groups of its flattened tokens
    -> (y, the groups' summed aux loss), on plain tensors."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    g = n_groups(xf.shape[0], cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for xi in xf.reshape(g, -1, d).unbind(0):
        yi, aux = _dispatch_group(p, xi, cfg, experts)
        aux_total = aux_total + aux
        ys.append(yi)
    return torch.cat(ys).reshape(b, s, d), aux_total / g


def _apply_moe_sharded(p, x: torch.Tensor, cfg: ModelConfig):
    """``apply_moe`` on a mesh.  The groups are JAX's, contiguous slices of
    the flattened tokens: where each rank's batch rows hold whole groups,
    each rank routes and dispatches its own groups, else every rank all of
    them.  The experts run where the rules put them (split over ``model``
    where the count divides): each rank takes its experts' slice of the
    dispatch buffer, runs their products, and the slices are gathered back
    before the combine, so each group's value is the one device's.  The
    router's and the experts' gradients are partial sums over the mesh dims
    that split the groups.  -> (y laid out as the token rows, aux
    replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.runtime.sharding import from_block, to_block

    mesh = x.device_mesh
    b, s = x.shape[:2]
    R = Replicate()
    rows = [q == Shard(0) for q in x.placements]
    n_rows = 1
    for i, r in enumerate(rows):
        n_rows *= mesh.size(i) if r else 1
    tg = b * s // n_groups(b * s, cfg)
    if b % n_rows or (b // n_rows * s) % tg:
        rows, n_rows = [False] * mesh.ndim, 1
    xpl = [Shard(0) if r else R for r in rows]
    ep = [q == Shard(0) and not r for q, r in zip(p["w_gate"].placements, rows)]
    wpl = [Shard(0) if e else R for e in ep]
    local = {"router": to_block(p["router"], [R] * mesh.ndim,
                                [Partial() if r else R for r in rows])}
    for name in ("w_gate", "w_up", "w_down"):
        local[name] = to_block(p[name], wpl, [Partial() if r else q for r, q in zip(rows, wpl)])
    # a group's buffer, stacked over the ranks that hold other groups
    whole = [Shard(0) if r else R for r in rows]
    split = [Shard(0) if r else Shard(1) if e else R for r, e in zip(rows, ep)]

    def experts(q, xs):
        shape = (n_rows, *xs.shape)
        mine = to_block(from_block(xs[None], mesh, whole, shape), split)[0]
        ys = _experts(q, mine)
        return to_block(from_block(ys[None], mesh, split, shape), whole)[0]

    y, aux = _routed(local, to_block(x, xpl), cfg, experts)
    y = from_block(y, mesh, xpl, x.shape)
    aux = from_block(aux, mesh, [Partial() if r else R for r in rows], ())
    aux = aux.redistribute(mesh, [R] * mesh.ndim) / n_rows
    if cfg.num_shared_experts:
        y = y + nn.swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    return y, aux
