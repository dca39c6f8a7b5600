"""Selective state-space blocks, Mamba1 (falcon-mamba-7b): the port of the
Mamba1 half of ``repro.models.mamba``.

The JAX module runs the sequence through an XLA chunked associative scan;
the port runs the same recurrence through ``kernels.mamba_scan``, whose
kernel K4 (on the card) computes exactly that scan's recurrence part.  The
gates are computed over the whole sequence first, and the D-skip and the
gating are added here, as the JAX scan body adds them.  Decode advances the
recurrence one token with plain tensor ops, as JAX does.

Roundings follow JAX under ``jit``: activations in bf16, the dt projection
with bf16 operands and an f32 result (XLA folds ``einsum(bf16).astype(f32)``
into one f32-result dot), the scan in f32, y rounded to bf16 before the
``silu(z)`` gate, and the gated result to bf16.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import selective_scan
from repro_torch.models import nn
from repro_torch.models.nn import ParamSpec, logical_constraint


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via k shifted adds. x: (B, S, C), w: (C, k)."""
    k = w.shape[1]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    for j in range(k):
        out = out + xp[:, j:j + s, :] * w[:, j].to(x.dtype)
    return out + b.to(x.dtype)


def causal_conv_step(x_t: torch.Tensor, tail: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One-token conv. x_t: (B, C); tail: (B, k-1, C) previous raw inputs."""
    window = torch.cat([tail, x_t[:, None, :]], dim=1)  # (B, k, C)
    out = torch.einsum("bkc,ck->bc", window, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return out, window[:, 1:, :]


def _conv_tail(x_raw: torch.Tensor, k: int) -> torch.Tensor:
    s = x_raw.shape[1]
    if s >= k - 1:
        return x_raw[:, s - (k - 1):, :].contiguous()
    return F.pad(x_raw, (0, 0, k - 1 - s, 0))


def mamba1_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, k, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank
    return {
        "ln": ParamSpec((d,), (None,), "ones"),
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((di, k), ("ssm_inner", None)),
        "conv_b": ParamSpec((di,), ("ssm_inner",), "zeros"),
        "x_proj": ParamSpec((di, r + 2 * n), ("ssm_inner", None)),
        "dt_w": ParamSpec((r, di), (None, "ssm_inner")),
        "dt_b": ParamSpec((di,), ("ssm_inner",), "dt_bias"),
        "A_log": ParamSpec((di, n), ("ssm_inner", None), "s4d"),
        "D": ParamSpec((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _mamba1_gates(cfg: ModelConfig, p, xi: torch.Tensor):
    """xi: (B, ..., di) post-conv activations -> dt, B, C (f32)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = torch.matmul(xi, p["x_proj"].to(xi.dtype))
    dt_low, bb, cc = torch.split(proj, [r, n, n], dim=-1)
    dt = torch.matmul(dt_low, p["dt_w"].to(xi.dtype))
    dt = F.softplus(dt.to(torch.float32) + p["dt_b"].to(torch.float32))
    return dt, bb.to(torch.float32), cc.to(torch.float32)


def mamba1_forward(cfg: ModelConfig, p, x: torch.Tensor, *, make_cache: bool = False):
    """x: (B, S, d) -> (y, cache | None)."""
    h = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    xz = torch.matmul(h, p["in_proj"].to(h.dtype))
    xi, z = xz.chunk(2, dim=-1)
    xi = logical_constraint(xi, "act_batch", None, "ssm_inner")
    xc = nn.silu(causal_conv(xi, p["conv_w"], p["conv_b"])).contiguous()

    A = -torch.exp(p["A_log"].to(torch.float32))  # (di, n)
    dt, bb, cc = _mamba1_gates(cfg, p, xc)
    y, h_last = selective_scan(dt.contiguous(), A.contiguous(), bb.contiguous(),
                               cc.contiguous(), xc)
    y = (y + p["D"].to(torch.float32) * xc.to(torch.float32)).to(x.dtype)
    y = (y.to(torch.float32) * nn.silu(z.to(torch.float32))).to(x.dtype)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))

    cache = None
    if make_cache:
        cache = {"state": h_last, "conv": _conv_tail(xi, cfg.ssm_conv)}
    return x + out, cache


def mamba1_decode(cfg: ModelConfig, p, x: torch.Tensor, cache):
    """x: (B, 1, d); cache {state: (B, di, n) f32, conv: (B, k-1, di)}."""
    h = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    xz = torch.matmul(h, p["in_proj"].to(h.dtype))
    xi, z = xz[:, 0].chunk(2, dim=-1)  # (B, di)
    xc, new_tail = causal_conv_step(xi, cache["conv"], p["conv_w"], p["conv_b"])
    xc = nn.silu(xc)
    dt, bb, cc = _mamba1_gates(cfg, p, xc)
    A = -torch.exp(p["A_log"].to(torch.float32))
    da = torch.exp(dt[..., None] * A)  # (B, di, n)
    dbx = (dt * xc.to(torch.float32))[..., None] * bb[:, None, :]
    hst = da * cache["state"] + dbx
    y = torch.einsum("bcn,bn->bc", hst, cc) + p["D"].to(torch.float32) * xc.to(torch.float32)
    y = (y * nn.silu(z.to(torch.float32))).to(x.dtype)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))[:, None]
    return x + out, {"state": hst, "conv": new_tail}


def mamba1_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    return {
        "state": ParamSpec((batch, cfg.d_inner, cfg.ssm_state), ("act_batch", "ssm_inner", None)),
        "conv": ParamSpec((batch, cfg.ssm_conv - 1, cfg.d_inner), ("act_batch", None, "ssm_inner")),
    }
