"""Decoder-only transformer trunk (port of ``repro.models.transformer``): the
dense GQA archs (minicpm, danube, stablelm, qwen3), the VLM's language
backbone (internvl2) and the MoE archs (deepseek-v2-lite with MLA, dbrx) as
segments.

Layers form *segments* of uniform structure whose parameters are stacked on a
leading ``layers`` axis, as in the JAX package; where JAX scans a segment, the
port loops over its layers.  Prefill attention goes through the flash kernel
(``kernels.flash_attention``); training attends through K3's training
instance and its hand-written backward K5 on plain bf16 CUDA tensors of a
head_dim they have, else through ``nn.attention`` as JAX does, with each
layer rematerialised in backward per ``cfg.remat``; decode attends over the (ring)
KV cache with plain products.  The decode step writes the new key and value
into the cache buffers in place (JAX returns updated copies; the serving loop
donates them).  MLA (q/k heads of 192, v heads of 128, which the flash kernel
does not take) attends through ``nn.attention`` at prefill too, as JAX does,
and decodes in the compressed latent with its up-projections absorbed.
Every attention core runs in a range of ``models.spans`` for the profile.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_train, trains
from repro_torch.models import moe as moe_lib
from repro_torch.models import nn, spans
from repro_torch.models.nn import ParamSpec, logical_constraint

PyTree = Any


# --------------------------------------------------------------------------
# segments
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    name: str
    n_layers: int
    is_moe: bool


def segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("seg0", cfg.num_layers, False)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense_layers:
            segs.append(Segment("seg0", cfg.first_dense_layers, False))
        segs.append(Segment(f"seg{len(segs)}", cfg.num_layers - cfg.first_dense_layers, True))
        return segs
    raise ValueError(f"transformer trunk does not build family {cfg.family!r}")


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    if cfg.attn_kind == "mla":
        h = cfg.num_heads
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        return {
            "wq": ParamSpec((d, h * qk), ("embed", "heads")),
            "w_dkv": ParamSpec((d, cfg.kv_lora_rank + cfg.qk_rope_dim), ("embed", "lora")),
            "kv_norm": ParamSpec((cfg.kv_lora_rank,), (None,), "ones"),
            "w_uk": ParamSpec((cfg.kv_lora_rank, h * cfg.qk_nope_dim), ("lora", "heads")),
            "w_uv": ParamSpec((cfg.kv_lora_rank, h * cfg.v_head_dim), ("lora", "heads")),
            "wo": ParamSpec((h * cfg.v_head_dim, d), ("heads", "embed")),
        }
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
    return {
        "ln1": ParamSpec((cfg.d_model,), (None,), "ones"),
        "attn": attn_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), (None,), "ones"),
        "ffn": moe_lib.moe_specs(cfg) if is_moe else mlp_specs(cfg),
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


def gqa_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor, *,
            decode: bool = False):
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = nn.split_last(nn.dense(x, p["wq"]), h)
    k = nn.split_last(nn.dense(x, p["wk"]), kvh)
    v = nn.split_last(nn.dense(x, p["wv"]), kvh)
    if cfg.qk_norm:
        q = nn.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = nn.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    if decode:
        # align with the cache sharding (kv_seq / kv_dh per the active rules)
        # so the products against the resident cache never re-shard it
        q = logical_constraint(q, "act_batch", None, None, "kv_dh")
        k = logical_constraint(k, "act_batch", None, None, "kv_dh")
        v = logical_constraint(v, "act_batch", None, None, "kv_dh")
        return q, k, v
    # train/prefill: q shards over the full `heads` dim; raw k/v keep
    # kv_heads unsharded (often fewer than the TP degree); the flash
    # kernel's wrapper takes the KV heads each rank's q heads need
    q = logical_constraint(q, "act_batch", None, "heads", None)
    k = logical_constraint(k, "act_batch", None, None, None)
    v = logical_constraint(v, "act_batch", None, None, None)
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
    """Full-sequence attention: through the flash kernel K3 at prefill; in
    training, through K3's training instance and its backward K5 where the
    inputs suit them (``flash_attention.ops.trains``: plain bf16 CUDA tensors
    of a head_dim they have), else through ``nn.attention`` (JAX's attention
    there)."""
    q, k, v = gqa_qkv(cfg, p, x, positions)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    if training and trains(q, k, v):
        o = spans.attention_core(flash_attention_train, q, k, v, causal=causal, window=window)
    elif training:
        o = spans.attention_core(nn.attention, q, k, v, causal=causal, window=window,
                                 chunk=cfg.attn_chunk)
    else:
        o = spans.attention_core(flash_attention, q, k, v, causal=causal, window=window)
    out = nn.dense(nn.merge_last(o), p["wo"])
    cache = None
    if make_cache:
        w = _cache_window(cfg, k.shape[1])
        s = k.shape[1]
        if w < s:  # ring-buffer extraction: keep last w positions at slot p % w
            kc, vc = _ring(k[:, s - w:], (s - w) % w), _ring(v[:, s - w:], (s - w) % w)
        else:
            kc, vc = k, v
        cache = {"k": kc, "v": vc}
    return out, cache


def _ring(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=1)``, as slices joined (which DTensors
    take)."""
    if shift == 0:
        return x
    return torch.cat([x[:, -shift:], x[:, :-shift]], dim=1)


def gqa_attn_decode(
    cfg: ModelConfig, p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against a (ring) KV cache. x: (B, 1, d), pos: the
    absolute write position.  Writes the new key/value into ``cache`` in place."""
    positions = torch.tensor([pos], device=x.device)
    q, k_new, v_new = gqa_qkv(cfg, p, x, positions, decode=True)
    k, v = cache["k"], cache["v"]
    w = k.shape[1]
    slot = pos % w
    nn.set_index(k, 1, slot, k_new[:, 0])
    nn.set_index(v, 1, slot, v_new[:, 0])

    with spans.span("attention.decode"):
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
    out = nn.dense(nn.merge_last(o), p["wo"])
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


# ---------------------------- MLA (deepseek) -------------------------------


def mla_project_q(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    q = nn.split_last(nn.dense(x, p["wq"]), cfg.num_heads)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, nn.apply_rope(q_rope, positions, cfg.rope_theta)


def mla_compress_kv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """-> (ckv (B, S, R) normed, k_rope (B, S, rope) rotated): what the cache holds."""
    ckv_rope = nn.dense(x, p["w_dkv"])
    ckv, k_rope = torch.split(ckv_rope, [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = nn.rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = nn.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def mla_attn_forward(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor, *,
                     make_cache: bool = False):
    """Prefill/train MLA: the compressed kv expanded to per-head K (192 =
    nope 128 + the rope key shared across heads) and V (128), through
    ``nn.attention`` (scale 1/sqrt(192), from q's last dim)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = mla_project_q(cfg, p, x, positions)
    ckv, k_rope = mla_compress_kv(cfg, p, x, positions)
    k_nope = nn.split_last(nn.dense(ckv, p["w_uk"]), h)
    v = nn.split_last(nn.dense(ckv, p["w_uv"]), h)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
    q = logical_constraint(q, "act_batch", None, "heads", None)
    k = logical_constraint(k, "act_batch", None, "heads", None)
    o = spans.attention_core(nn.attention, q, k, v, causal=True, chunk=cfg.attn_chunk)
    out = nn.dense(nn.merge_last(o), p["wo"])
    cache = {"ckv": ckv, "krope": k_rope} if make_cache else None
    return out, cache


def mla_attn_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    pos: int):
    """Absorbed MLA decode: attention runs in the compressed kv_lora space,
    in f32, over the (B, S, R + rope) cache; ``w_uk`` is folded into q and
    ``w_uv`` applied after the softmax.  Writes the new ``ckv``/``krope`` row
    into ``cache`` in place; keys past ``pos`` are masked."""
    h = cfg.num_heads
    positions = torch.tensor([pos], device=x.device)
    q_nope, q_rope = mla_project_q(cfg, p, x, positions)  # (B, 1, H, *)
    ckv_new, krope_new = mla_compress_kv(cfg, p, x, positions)
    ckv, krope = cache["ckv"], cache["krope"]
    nn.set_index(ckv, 1, pos, ckv_new[:, 0])
    nn.set_index(krope, 1, pos, krope_new[:, 0])

    w_uk = nn.split_last(p["w_uk"], h).to(x.dtype)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)  # absorb the k up-projection
    with spans.span("attention.decode"):
        ckv32 = ckv.to(torch.float32)
        scores = torch.einsum("bhr,bsr->bhs", q_abs.to(torch.float32), ckv32)
        scores = scores + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(torch.float32),
                                       krope.to(torch.float32))
        scores = scores / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
        kv_pos = torch.arange(ckv.shape[1], device=x.device)
        scores = scores.masked_fill((kv_pos > pos)[None, None, :], nn.NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhs,bsr->bhr", probs, ckv32).to(x.dtype)
    w_uv = nn.split_last(p["w_uv"], h).to(x.dtype)
    o = torch.einsum("bhr,rhd->bhd", ctx, w_uv)  # absorb the v up-projection
    out = nn.dense(nn.merge_last(o), p["wo"])[:, None, :]
    return out, {"ckv": ckv, "krope": krope}


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
    p = nn.gather_fsdp(p)
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, cache = mla_attn_forward(cfg, p["attn"], h, positions, make_cache=make_cache)
    else:
        a, cache = gqa_attn_forward(cfg, p["attn"], h, positions, make_cache=make_cache,
                                    causal=causal, training=training)
    x = x + a
    h = nn.rms_norm(x, p["ln2"], cfg.norm_eps)
    if is_moe:
        f, aux = moe_lib.apply_moe(p["ffn"], h, cfg)
    else:
        f = nn.swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"], p["ffn"]["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + f
    x = logical_constraint(x, "act_batch", None, None)
    return x, cache, aux


def apply_block_decode(cfg: ModelConfig, p, x, cache, pos: int, *, is_moe: bool):
    p = nn.gather_fsdp(p)
    h = nn.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, new_cache = mla_attn_decode(cfg, p["attn"], h, cache, pos)
    else:
        a, new_cache = gqa_attn_decode(cfg, p["attn"], h, cache, pos)
    x = x + a
    h = nn.rms_norm(x, p["ln2"], cfg.norm_eps)
    if is_moe:
        f, _ = moe_lib.apply_moe(p["ffn"], h, cfg)
    else:
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
            out[seg.name] = {
                "ckv": ParamSpec((seg.n_layers, batch, seq_len, cfg.kv_lora_rank),
                                 ("layers", "act_batch", "kv_seq", "kv_dh")),
                "krope": ParamSpec((seg.n_layers, batch, seq_len, cfg.qk_rope_dim),
                                   ("layers", "act_batch", "kv_seq", None)),
            }
            continue
        kvshape = (seg.n_layers, batch, w, cfg.num_kv_heads, cfg.head_dim)
        axes = ("layers", "act_batch", "kv_seq", None, "kv_dh")
        out[seg.name] = {"k": ParamSpec(kvshape, axes), "v": ParamSpec(kvshape, axes)}
    return out
