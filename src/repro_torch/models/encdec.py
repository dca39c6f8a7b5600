"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).
The conv/mel frontend is a stub, as in the JAX package: precomputed frame
embeddings (B, S, d_model) go straight into the encoder.  Sinusoidal
positions, MHA, pre-norm blocks; the decoder has causal self-attention
(cached at decode) and cross-attention over the encoder states (K/V cached
once at prefill).

Attention follows ``transformer.gqa_attn_forward``'s split: at prefill the
encoder's, the decoder's and the cross-attention go through the flash kernel
(``kernels.flash_attention``; non-causal for the encoder and the cross), in
training through ``nn.attention``; decode attends with plain products.  Where
JAX scans the stacked layers, the port loops over them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import nn, transformer
from repro_torch.models.nn import ParamSpec


def cross_attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h * dh), ("embed", "heads")),
        "wk": ParamSpec((d, h * dh), ("embed", "heads")),
        "wv": ParamSpec((d, h * dh), ("embed", "heads")),
        "wo": ParamSpec((h * dh, d), ("heads", "embed")),
    }


def enc_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return transformer.block_specs(cfg, is_moe=False)


def dec_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s = transformer.block_specs(cfg, is_moe=False)
    s["lnx"] = ParamSpec((cfg.d_model,), (None,), "ones")
    s["cross"] = cross_attn_specs(cfg)
    return s


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
        "enc": nn.stack_specs(enc_block_specs(cfg), cfg.enc_layers),
        "dec": nn.stack_specs(dec_block_specs(cfg), cfg.dec_layers),
        "ln_enc": ParamSpec((cfg.d_model,), (None,), "ones"),
        "ln_f": ParamSpec((cfg.d_model,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def _cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    b, s, _ = enc_out.shape
    h, dh = cfg.num_heads, cfg.head_dim
    k = torch.matmul(enc_out, p["wk"].to(enc_out.dtype)).reshape(b, s, h, dh)
    v = torch.matmul(enc_out, p["wv"].to(enc_out.dtype)).reshape(b, s, h, dh)
    return k, v


def _cross_attn(cfg: ModelConfig, p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                kernel: bool):
    """Non-causal attention of the decoder's x over the encoder's K/V: through
    the flash kernel when ``kernel`` (prefill), else ``nn.attention``
    (training, decode)."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"].to(x.dtype)).reshape(b, s, h, dh)
    if kernel:
        o = flash_attention(q, k, v, causal=False)
    else:
        o = nn.attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return torch.matmul(o.reshape(b, s, -1), p["wo"].to(x.dtype))


def _add_positions(cfg: ModelConfig, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    return x + nn.sinusoidal_pos(x.shape[1], cfg.d_model, offset, x.device).to(x.dtype)


def _remat(fn, cfg: ModelConfig, training: bool):
    """JAX's enc-dec rematerialises each layer whole (``jax.checkpoint``
    without a policy) unless ``cfg.remat`` is ``"nothing"``."""
    if cfg.remat != "nothing":
        cfg = dataclasses.replace(cfg, remat="full")
    return nn.remat(fn, cfg, training)


def encode(cfg: ModelConfig, params, frames: torch.Tensor, *, training: bool) -> torch.Tensor:
    """frames (B, S, d) -> the normed encoder states (B, S, d)."""
    x = _add_positions(cfg, frames)
    positions = torch.arange(frames.shape[1], device=frames.device)

    def body(p_l, xx):
        xx, _, _ = transformer.apply_block(cfg, p_l, xx, positions, is_moe=False, causal=False,
                                           training=training)
        return xx

    body = _remat(body, cfg, training)
    for p_l in nn.unstack(params["enc"]):
        x = body(p_l, x)
    return nn.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, p_l, x, enc_out, positions, *, make_cache: bool,
               training: bool):
    h = nn.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    a, self_cache = transformer.gqa_attn_forward(cfg, p_l["attn"], h, positions,
                                                 make_cache=make_cache, causal=True,
                                                 training=training)
    x = x + a
    h = nn.rms_norm(x, p_l["lnx"], cfg.norm_eps)
    ck, cv = _cross_kv(cfg, p_l["cross"], enc_out)
    x = x + _cross_attn(cfg, p_l["cross"], h, ck, cv, kernel=not training)
    h = nn.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    x = x + nn.swiglu(h, p_l["ffn"]["w_gate"], p_l["ffn"]["w_up"], p_l["ffn"]["w_down"])
    cache = None
    if make_cache:
        cache = {"k": self_cache["k"], "v": self_cache["v"], "ck": ck, "cv": cv}
    return x, cache


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 training: bool, make_cache: bool = False):
    """Teacher-forced decoder over ``tokens`` (B, S) -> (hidden normed by
    ``ln_f``, the cache stacked over layers or None)."""
    x = params["embed"].to(enc_out.dtype)[tokens.long()]
    x = _add_positions(cfg, x)
    positions = torch.arange(tokens.shape[1], device=x.device)
    block = _remat(functools.partial(_dec_block, cfg, make_cache=make_cache,
                                     training=training), cfg, training)
    layer_caches = []
    for p_l in nn.unstack(params["dec"]):
        x, cache = block(p_l, x, enc_out, positions)
        layer_caches.append(cache)
    caches = None
    if make_cache:  # stacked on a leading layers axis
        caches = {key: torch.stack([c[key] for c in layer_caches]) for key in layer_caches[0]}
    return nn.rms_norm(x, params["ln_f"], cfg.norm_eps), caches


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor, pos: int):
    """token: (B,) integer; caches from prefill (self K/V grown for decode,
    cross K/V at the frame count), written in place.  -> (hidden (B, 1, d)
    normed by ``ln_f``, caches)."""
    x = params["embed"][token.long()][:, None, :].to(torch.bfloat16)
    x = _add_positions(cfg, x, pos)
    for i in range(cfg.dec_layers):
        p_l, c_l = nn.layer(params["dec"], i), nn.layer(caches, i)
        h = nn.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        a, _ = transformer.gqa_attn_decode(cfg, p_l["attn"], h, {"k": c_l["k"], "v": c_l["v"]},
                                           pos)
        x = x + a
        h = nn.rms_norm(x, p_l["lnx"], cfg.norm_eps)
        x = x + _cross_attn(cfg, p_l["cross"], h, c_l["ck"], c_l["cv"], kernel=False)
        h = nn.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        x = x + nn.swiglu(h, p_l["ffn"]["w_gate"], p_l["ffn"]["w_up"], p_l["ffn"]["w_down"])
    return nn.rms_norm(x, params["ln_f"], cfg.norm_eps), caches


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    l, h, dh = cfg.dec_layers, cfg.num_heads, cfg.head_dim
    self_shape = (l, batch, seq_len, cfg.num_kv_heads, dh)  # self-attn stores kv heads
    cross_shape = (l, batch, seq_len, h, dh)  # cross K/V use full heads (MHA proj)
    axes = ("layers", "act_batch", "kv_seq", None, "kv_dh")
    return {
        "k": ParamSpec(self_shape, axes),
        "v": ParamSpec(self_shape, axes),
        "ck": ParamSpec(cross_shape, axes),
        "cv": ParamSpec(cross_shape, axes),
    }
