"""Model API of the port (port of ``repro.models.model``): the dense, MoE,
SSM, hybrid, VLM and enc-dec (audio) families.

    model_specs(cfg)            -> ParamSpec tree (single source of truth)
    loss_fn(cfg, params, batch) -> (loss, metrics)      [train]
    prefill(cfg, params, batch) -> (last_logits, cache) [inference-prefill]
    decode_step(cfg, params, cache, token, pos)         [inference-decode]
    cache_specs(cfg, batch, seq_len)

The cross-entropy is computed in sequence chunks against the head, so the
full (B, S, V) logits are never materialized.  A VLM batch carries
``patches`` (B, P, d), put in front of the embedded tokens; an audio batch
``frames`` (B, S, d), the encoder's input.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba, nn, transformer
from repro_torch.models.nn import ParamSpec

LOSS_CHUNK = 256
COMPUTE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "audio":
        return encdec.model_specs(cfg)
    if cfg.family in ("ssm", "hybrid"):
        s: Dict[str, Any] = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed")),
            "ln_f": ParamSpec((cfg.d_model,), (None,), "ones"),
        }
        if cfg.family == "ssm":
            s["blocks"] = nn.stack_specs(mamba.mamba1_specs(cfg), cfg.num_layers)
        else:
            s["trunk"] = hybrid.trunk_specs(cfg)
        if not cfg.tie_embeddings:
            s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
        return s
    return transformer.lm_specs(cfg)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """All parameters, or with ``active_only`` those a token passes: of each
    MoE layer's routed experts only ``top_k``."""
    total = nn.param_count(model_specs(cfg))
    if active_only and cfg.family == "moe":
        moe_layers = cfg.num_layers - cfg.first_dense_layers
        routed = moe_layers * cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff
        active = moe_layers * cfg.top_k * 3 * cfg.d_model * cfg.moe_d_ff
        total = total - routed + active
    return total


def stub_inputs(cfg: ModelConfig, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The stub frontends' inputs for a batch of ``tokens`` (B, S), as JAX's
    drivers feed them: zero patch embeddings (B, num_prefix_tokens, d) for a
    VLM, zero frames (B, S, d) for an audio model, in bf16; none otherwise."""
    b, s = tokens.shape
    if cfg.family == "vlm":
        return {"patches": torch.zeros((b, cfg.num_prefix_tokens, cfg.d_model),
                                       dtype=COMPUTE_DTYPE, device=tokens.device)}
    if cfg.family == "audio":
        return {"frames": torch.zeros((b, s, cfg.d_model), dtype=COMPUTE_DTYPE,
                                      device=tokens.device)}
    return {}


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"].to(COMPUTE_DTYPE)[tokens.long()]


def _head_weight(cfg: ModelConfig, params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # (d, V)
    return params["lm_head"]


def logits_at(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden: (..., d) -> f32 logits (..., V).  bf16 operands with an f32
    result, never rounded to bf16: what XLA compiles ``einsum(...).astype(f32)``
    to (products of bf16 values are exact in f32)."""
    w = _head_weight(cfg, params).to(COMPUTE_DTYPE)
    return torch.matmul(hidden.to(COMPUTE_DTYPE).to(torch.float32), w.to(torch.float32))


# --------------------------------------------------------------------------
# trunk forward
# --------------------------------------------------------------------------


def forward_hidden(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
                   training: bool = False, make_cache: bool = False):
    """Returns (hidden, cache, aux_loss).  ``training`` takes the
    differentiable paths (``nn.attention``, the chunked SSM scan) and
    rematerialises each layer per ``cfg.remat``; otherwise prefill goes
    through the kernels.  A VLM's hidden states are those of the text
    positions only; its cache holds the patch positions too."""
    if cfg.family == "audio":
        frames = batch["frames"].to(COMPUTE_DTYPE)
        enc_out = encdec.encode(cfg, params, frames, training=training)
        x, cache = encdec.decode_train(cfg, params, batch["tokens"], enc_out, training=training,
                                       make_cache=make_cache)
        return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)
    x = _embed(cfg, params, batch["tokens"])
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(COMPUTE_DTYPE), x], dim=1)
    if cfg.family == "ssm":
        block = nn.remat(functools.partial(mamba.mamba1_forward, cfg, make_cache=make_cache,
                                         training=training), cfg, training)
        layer_caches = []
        for p_l in nn.unstack(params["blocks"]):
            x, c = block(p_l, x)
            layer_caches.append(c)
        cache = None
        if make_cache:  # stacked on a leading layers axis; the state stays f32
            cache = {key: torch.stack([c[key] for c in layer_caches]) for key in ("state", "conv")}
        x = nn.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x, cache, zero
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "hybrid":  # the embedding is both the trunk's input and its side input
        x, cache = hybrid.trunk_forward(cfg, params["trunk"], x, x, positions, training=training,
                                        make_cache=make_cache)
        x = nn.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x, cache, zero
    x, cache, aux = transformer.trunk_forward(cfg, params, x, positions, training=training,
                                              make_cache=make_cache)
    x = nn.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, batch["patches"].shape[1]:]  # loss over text positions only
    return x, cache, aux


# --------------------------------------------------------------------------
# chunked cross-entropy loss
# --------------------------------------------------------------------------


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *, training: bool = True,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """-> (loss, metrics).  Cross-entropy over ``LOSS_CHUNK`` positions at a
    time (one chunk when the sequence does not divide), with f32 logits from
    bf16 operands as in ``logits_at``; labels < 0 are masked; a z-loss on
    logsumexp.  ``metrics`` hold detached values: loss, ce, aux, tokens."""
    hidden, _, aux = forward_hidden(cfg, params, batch, training=training)
    labels = batch["labels"].long()
    w = _head_weight(cfg, params).to(COMPUTE_DTYPE).to(torch.float32)

    s = hidden.shape[1]
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll_sum, z_sum, cnt = zero, zero, zero
    for i in range(0, s, chunk):
        h_c, l_c = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        logits = torch.matmul(h_c.to(COMPUTE_DTYPE).to(torch.float32), w)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, l_c.clamp_min(0)[..., None])[..., 0]
        mask = (l_c >= 0).to(torch.float32)
        nll_sum = nll_sum + ((logz - ll) * mask).sum()
        z_sum = z_sum + (logz.square() * mask).sum()
        cnt = cnt + mask.sum()
    cnt = cnt.clamp_min(1.0)
    ce = nll_sum / cnt
    loss = ce + z_weight * z_sum / cnt + aux_weight * aux
    metrics = {"loss": loss.detach(), "ce": ce.detach(), "aux": aux.detach(), "tokens": cnt}
    return loss, metrics


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    hidden, cache, _ = forward_hidden(cfg, params, batch, make_cache=True)
    return logits_at(cfg, params, hidden[:, -1, :]), cache


def decode_step(cfg: ModelConfig, params, cache, token: torch.Tensor, pos: int):
    """token: (B,) integer, pos: the write position (a VLM's counts its patch
    positions). -> (logits, cache); the cache is updated in place."""
    if cfg.family == "audio":  # the decoder applies ln_f itself
        x, cache = encdec.decode_step(cfg, params, cache, token, pos)
        return logits_at(cfg, params, x[:, 0]), cache
    x = _embed(cfg, params, token)[:, None, :]
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x, c = mamba.mamba1_decode(cfg, nn.layer(params["blocks"], i), x, nn.layer(cache, i))
            cache["state"][i] = c["state"]
            cache["conv"][i] = c["conv"]
    elif cfg.family == "hybrid":
        x, cache = hybrid.trunk_decode(cfg, params["trunk"], x, x, cache, pos)
    else:
        x, cache = transformer.trunk_decode(cfg, params, x, cache, pos)
    x = nn.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return logits_at(cfg, params, x[:, 0]), cache


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Any:
    if cfg.family == "audio":
        return encdec.cache_specs(cfg, batch, seq_len)
    if cfg.family == "ssm":
        return nn.stack_specs(mamba.mamba1_cache_specs(cfg, batch), cfg.num_layers)
    if cfg.family == "hybrid":
        return hybrid.cache_specs(cfg, batch, seq_len)
    return transformer.cache_specs(cfg, batch, seq_len)
