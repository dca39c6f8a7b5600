"""Decoder-only transformer trunk, dense GQA family (port of the dense
branches of ``repro.models.transformer``: minicpm, danube, stablelm, qwen3).

Layers form *segments* of uniform structure whose parameters are stacked on a
leading ``layers`` axis, as in the JAX package; where JAX scans a segment, the
port loops over its layers.  Prefill attention goes through the flash kernel
(``kernels.flash_attention``); training attends through ``nn.attention`` as
JAX does (the kernel, like the Pallas one, is forward-only), with each layer
rematerialised in backward per ``cfg.remat``; decode attends over the (ring)
KV cache with plain products.  The decode step writes the new key and value
into the cache buffers in place (JAX returns updated copies; the serving loop
donates them).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import nn
from repro_torch.models.nn import ParamSpec, logical_constraint

PyTree = Any

_MOE_MLA = "MoE and MLA are not ported yet (ROADMAP Queue 1 item 13)"


# --------------------------------------------------------------------------
# segments
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    name: str
    n_layers: int
    is_moe: bool


def segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family == "dense":
        return [Segment("seg0", cfg.num_layers, False)]
    if cfg.family == "moe":
        raise NotImplementedError(_MOE_MLA)
    if cfg.family == "vlm":
        raise NotImplementedError("the VLM family is not ported yet (ROADMAP Queue 1 item 14)")
    raise ValueError(f"transformer trunk does not build family {cfg.family!r}")


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if cfg.attn_kind == "mla":
        raise NotImplementedError(_MOE_MLA)
    d = cfg.d_model
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h * dh), ("embed", "heads")),
        "wk": ParamSpec((d, kvh * dh), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kvh * dh), ("embed", "kv_heads")),
        "wo": ParamSpec((h * dh, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), (None,), "ones")
        s["k_norm"] = ParamSpec((dh,), (None,), "ones")
    return s


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def block_specs(cfg: ModelConfig, is_moe: bool) -> Dict[str, Any]:
    if is_moe:
        raise NotImplementedError(_MOE_MLA)
    return {
        "ln1": ParamSpec((cfg.d_model,), (None,), "ones"),
        "attn": attn_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), (None,), "ones"),
        "ffn": mlp_specs(cfg),
    }


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "ln_f": ParamSpec((cfg.d_model,), (None,), "ones"),
    }
    for seg in segments(cfg):
        s[seg.name] = nn.stack_specs(block_specs(cfg, seg.is_moe), seg.n_layers)
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


# --------------------------------------------------------------------------
# attention application
# --------------------------------------------------------------------------


def _cache_window(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.attn_kind == "swa":
        return min(cfg.window, seq_len)
    return seq_len


def gqa_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"].to(x.dtype)).reshape(b, s, h, dh)
    k = torch.matmul(x, p["wk"].to(x.dtype)).reshape(b, s, kvh, dh)
    v = torch.matmul(x, p["wv"].to(x.dtype)).reshape(b, s, kvh, dh)
    if cfg.qk_norm:
        q = nn.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = nn.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attn_forward(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    make_cache: bool = False,
    causal: bool = True,
    training: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence attention: through the flash kernel at prefill, through
    ``nn.attention`` in training (JAX's attention there; the kernel has no
    backward)."""
    q, k, v = gqa_qkv(cfg, p, x, positions)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    if training:
        o = nn.attention(q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk)
    else:
        o = flash_attention(q, k, v, causal=causal, window=window)
    out = torch.matmul(o.reshape(o.shape[0], o.shape[1], -1), p["wo"].to(x.dtype))
    cache = None
    if make_cache:
        w = _cache_window(cfg, k.shape[1])
        s = k.shape[1]
        if w < s:  # ring-buffer extraction: keep last w positions at slot p % w
            sl = (torch.arange(w, device=k.device) + (s - w)) % w
            kc = k.new_zeros((k.shape[0], w, *k.shape[2:]))
            vc = v.new_zeros((v.shape[0], w, *v.shape[2:]))
            kc[:, sl] = k[:, s - w:]
            vc[:, sl] = v[:, s - w:]
        else:
            kc, vc = k, v
        cache = {"k": kc, "v": vc}
    return out, cache


def gqa_attn_decode(
    cfg: ModelConfig, p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a (ring) KV cache. x: (B, 1, d), pos: the
    absolute write position.  Writes the new key/value into ``cache`` in place."""
    positions = torch.tensor([pos], device=x.device)
    q, k_new, v_new = gqa_qkv(cfg, p, x, positions)
    k, v = cache["k"], cache["v"]
    w = k.shape[1]
    slot = pos % w
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]

    if cfg.attn_kind == "swa":
        # ring buffer: slot i holds absolute position pos - ((pos - i) mod w);
        # everything resident is inside the window by construction.
        kv_positions = pos - torch.remainder(pos - torch.arange(w, device=x.device), w)
        valid = kv_positions >= 0
        o = _decode_attn_abs(cfg, q, k, v, kv_positions, valid)
    else:
        o = nn.attention(
            q, k, v, causal=False, window=0, chunk=cfg.attn_chunk, kv_len=pos + 1
        )
    out = torch.matmul(o.reshape(o.shape[0], 1, -1), p["wo"].to(x.dtype))
    return out, {"k": k, "v": v}


def _decode_attn_abs(cfg, q, k, v, kv_positions, valid):
    """Decode attention with explicit absolute kv positions (ring buffers).
    Grouped over the KV heads instead of repeating them: the same products."""
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    qg = q[:, 0].reshape(b, kvh, h // kvh, dh).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32)) / math.sqrt(dh)
    scores = scores.masked_fill(~valid[None, None, None, :], nn.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum(
        "bkgs,bskd->bkgd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return o.reshape(b, h, -1)[:, None].to(q.dtype)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def apply_block(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    is_moe: bool,
    make_cache: bool = False,
    causal: bool = True,
    training: bool = False,
):
    if is_moe or cfg.attn_kind == "mla":
        raise NotImplementedError(_MOE_MLA)
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = gqa_attn_forward(cfg, p["attn"], h, positions, make_cache=make_cache,
                                causal=causal, training=training)
    x = x + a
    h = nn.rms_norm(x, p["ln2"], cfg.norm_eps)
    f = nn.swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + f
    x = logical_constraint(x, "act_batch", None, None)
    return x, cache, aux


def apply_block_decode(cfg: ModelConfig, p, x, cache, pos: int, *, is_moe: bool):
    if is_moe or cfg.attn_kind == "mla":
        raise NotImplementedError(_MOE_MLA)
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = gqa_attn_decode(cfg, p["attn"], h, cache, pos)
    x = x + a
    h = nn.rms_norm(x, p["ln2"], cfg.norm_eps)
    f = nn.swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"])
    return x + f, new_cache


# --------------------------------------------------------------------------
# trunk forward / prefill / decode over segments
# --------------------------------------------------------------------------


def trunk_forward(cfg: ModelConfig, params, x: torch.Tensor, positions: torch.Tensor, *,
                  training: bool = False, make_cache: bool = False):
    """x: (B, S, d) -> (hidden, cache_by_segment, aux_loss)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    for seg in segments(cfg):
        block = nn.remat(
            functools.partial(apply_block, cfg, is_moe=seg.is_moe, make_cache=make_cache,
                              training=training),
            cfg, training,
        )
        layer_caches = []
        for p_l in nn.unstack(params[seg.name]):
            x, cache, a = block(p_l, x, positions)
            aux_total = aux_total + a
            layer_caches.append(cache)
        if make_cache:
            caches[seg.name] = {
                key: torch.stack([c[key] for c in layer_caches]) for key in layer_caches[0]
            }
    return x, caches, aux_total


def trunk_decode(cfg: ModelConfig, params, x, caches, pos: int):
    """One token through every layer; the stacked caches are updated in place."""
    for seg in segments(cfg):
        for i in range(seg.n_layers):
            x, _ = apply_block_decode(
                cfg, nn.layer(params[seg.name], i), x, nn.layer(caches[seg.name], i), pos,
                is_moe=seg.is_moe,
            )
    return x, caches


# --------------------------------------------------------------------------
# cache specs
# --------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    out = {}
    w = _cache_window(cfg, seq_len)
    for seg in segments(cfg):
        if cfg.attn_kind == "mla":
            raise NotImplementedError(_MOE_MLA)
        kvshape = (seg.n_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        axes = ("layers", "act_batch", "kv_seq", None, "kv_dh")
        out[seg.name] = {"k": ParamSpec(kvshape, axes), "v": ParamSpec(kvshape, axes)}
    return out
