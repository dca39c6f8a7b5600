"""Zamba2-style hybrid (port of ``repro.models.hybrid``): a Mamba2 backbone
with ONE shared attention+MLP block applied every ``attn_every`` SSM blocks.
The shared block reuses a single parameter set across invocations, with small
per-invocation LoRA adapters on the q/k/v projections, and consumes the
concatenation [hidden, original embedding] (2·d_model wide).

Prefill attention goes through the flash kernel (``kernels.flash_attention``),
once per invocation; training attends through ``nn.attention`` as JAX does
(the kernel, like the Pallas one, is forward-only); decode attends over the
whole cache with ``kv_len = pos + 1`` and writes the new key and value into
the cache buffers in place.  In training each Mamba2 layer is rematerialised
per ``cfg.remat`` as in JAX, and so is each invocation of the shared block,
which JAX keeps whole: at zamba2's width its f32 attention scores would hold
~8.6 GB an invocation for backward at batch 2 x 4096.  Recomputation changes
no value.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import mamba, nn
from repro_torch.models.nn import ParamSpec


def n_invocations(cfg: ModelConfig) -> int:
    return -(-cfg.num_layers // cfg.attn_every)  # ceil


def _groups(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """[(start_layer, n_layers)] per shared-block invocation."""
    out = []
    for g in range(n_invocations(cfg)):
        lo = g * cfg.attn_every
        hi = min(lo + cfg.attn_every, cfg.num_layers)
        out.append((lo, hi - lo))
    return out


def shared_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d2 = 2 * cfg.d_model
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r, ninv = cfg.shared_lora_rank, n_invocations(cfg)
    s: Dict[str, Any] = {
        "ln1": ParamSpec((d2,), (None,), "ones"),
        "wq": ParamSpec((d2, h * dh), ("embed", "heads")),
        "wk": ParamSpec((d2, kvh * dh), ("embed", "kv_heads")),
        "wv": ParamSpec((d2, kvh * dh), ("embed", "kv_heads")),
        "wo": ParamSpec((h * dh, cfg.d_model), ("heads", "embed")),
        "ln2": ParamSpec((d2,), (None,), "ones"),
        "w_gate": ParamSpec((d2, cfg.d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d2, cfg.d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
    }
    if r:
        for nme, width in (("q", h * dh), ("k", kvh * dh), ("v", kvh * dh)):
            s[f"lora_{nme}_a"] = ParamSpec((ninv, d2, r), (None, "embed", None), "normal", 0.1)
            s[f"lora_{nme}_b"] = ParamSpec((ninv, r, width), (None, None, "heads"), "zeros")
    return s


def _shared_qkv(cfg: ModelConfig, p, cat: torch.Tensor, inv: int, positions: torch.Tensor):
    b, s, _ = cat.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(name, heads):
        y = torch.matmul(cat, p[f"w{name}"].to(cat.dtype))
        if cfg.shared_lora_rank:
            la = p[f"lora_{name}_a"][inv].to(cat.dtype)
            lb = p[f"lora_{name}_b"][inv].to(cat.dtype)
            y = y + torch.matmul(torch.matmul(cat, la), lb)
        return y.reshape(b, s, heads, dh)

    q, k, v = proj("q", h), proj("k", kvh), proj("v", kvh)
    if cfg.pos_embed == "rope":
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _shared_out(cfg: ModelConfig, p, x: torch.Tensor, emb: torch.Tensor, o: torch.Tensor):
    """The attention's output projection and the MLP over [x, emb]."""
    x = x + torch.matmul(o.reshape(*o.shape[:2], -1), p["wo"].to(x.dtype))
    hh = nn.rms_norm(torch.cat([x, emb], dim=-1), p["ln2"], cfg.norm_eps)
    return x + nn.swiglu(hh, p["w_gate"], p["w_up"], p["w_down"])


def apply_shared_block(cfg: ModelConfig, p, x: torch.Tensor, emb: torch.Tensor, inv: int,
                       positions: torch.Tensor, *, make_cache: bool = False,
                       training: bool = False):
    hh = nn.rms_norm(torch.cat([x, emb], dim=-1), p["ln1"], cfg.norm_eps)
    q, k, v = _shared_qkv(cfg, p, hh, inv, positions)
    if training:
        o = nn.attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    else:
        o = flash_attention(q, k, v, causal=True, window=0)
    x = _shared_out(cfg, p, x, emb, o)
    cache = {"k": k, "v": v} if make_cache else None
    return x, cache


def apply_shared_block_decode(cfg: ModelConfig, p, x, emb, inv: int, cache, pos: int):
    """One token. cache: {k, v: (B, S, KVH, dh)} for this invocation; the new
    key and value are written at ``pos`` in place."""
    positions = torch.tensor([pos], device=x.device)
    hh = nn.rms_norm(torch.cat([x, emb], dim=-1), p["ln1"], cfg.norm_eps)
    q, k_new, v_new = _shared_qkv(cfg, p, hh, inv, positions)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0]
    v[:, pos] = v_new[:, 0]
    o = nn.attention(q, k, v, causal=False, chunk=cfg.attn_chunk, kv_len=pos + 1)
    return _shared_out(cfg, p, x, emb, o), {"k": k, "v": v}


# --------------------------------------------------------------------------
# full trunk
# --------------------------------------------------------------------------


def trunk_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "mamba": nn.stack_specs(mamba.mamba2_specs(cfg), cfg.num_layers),
        "shared": shared_block_specs(cfg),
    }


def trunk_forward(cfg: ModelConfig, params, x, emb, positions, *, training: bool,
                  make_cache: bool = False):
    """x, emb: (B, S, d) -> (hidden, caches | None)."""
    shared = nn.remat(functools.partial(apply_shared_block, cfg, make_cache=make_cache,
                                      training=training), cfg, training)
    layer = nn.remat(functools.partial(mamba.mamba2_forward, cfg, make_cache=make_cache),
                   cfg, training)
    layers = nn.unstack(params["mamba"])
    attn_caches, ssm_caches = [], []
    for inv, (lo, n) in enumerate(_groups(cfg)):
        x, ac = shared(params["shared"], x, emb, inv, positions)
        attn_caches.append(ac)
        group = []
        for p_l in layers[lo:lo + n]:
            x, c = layer(p_l, x)
            group.append(c)
        ssm_caches.append(group)

    caches = None
    if make_cache:
        caches = {
            "attn": {key: torch.stack([c[key] for c in attn_caches]) for key in ("k", "v")},
            # ssm caches are grouped; keep per-group keys for the re-scan
            **{f"ssm{g}": {key: torch.stack([c[key] for c in group]) for key in ("state", "conv")}
               for g, group in enumerate(ssm_caches)},
        }
    return x, caches


def trunk_decode(cfg: ModelConfig, params, x, emb, caches, pos: int):
    """One token through every invocation and layer; the caches are updated in
    place."""
    ak, av = caches["attn"]["k"], caches["attn"]["v"]
    for inv, (lo, n) in enumerate(_groups(cfg)):
        x, _ = apply_shared_block_decode(cfg, params["shared"], x, emb, inv,
                                         {"k": ak[inv], "v": av[inv]}, pos)
        group = caches[f"ssm{inv}"]
        for i in range(n):
            x, c = mamba.mamba2_decode(cfg, nn.layer(params["mamba"], lo + i), x, nn.layer(group, i))
            group["state"][i] = c["state"]
            group["conv"][i] = c["conv"]
    return x, caches


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    ninv = n_invocations(cfg)
    kvshape = (ninv, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    axes = (None, "act_batch", "kv_seq", None, "kv_dh")
    out: Dict[str, Any] = {
        "attn": {"k": ParamSpec(kvshape, axes), "v": ParamSpec(kvshape, axes)}
    }
    for g, (lo, n) in enumerate(_groups(cfg)):
        out[f"ssm{g}"] = nn.stack_specs(mamba.mamba2_cache_specs(cfg, batch), n)
    return out
