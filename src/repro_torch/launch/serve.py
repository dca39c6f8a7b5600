"""Serving driver (port of ``repro.launch.serve``): batched prefill -> greedy
decode on one device, with the DaeMon working copy of the weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --batch 2 --prompt-len 8192 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --batch 2 --prompt-len 8192 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --batch 2 --prompt-len 8192 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --batch 2 --prompt-len 8192 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --batch 16 --prompt-len 1500 --gen 16

A VLM (internvl2) is served with zero patch embeddings in front of the
prompt, an audio model (whisper) with zero frames as long as the prompt, as
in JAX's driver.  internvl2-76b at full depth does not fit one card;
``serve_config`` serves a config cut in depth.

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs import get_config
from repro_torch.core import movement as mv
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.models import nn


def serve(
    arch: str,
    *,
    reduced: bool = True,
    batch: int = 4,
    prompt_len: int = 64,
    gen_tokens: int = 32,
    movement: str = "daemon",
    mesh_shape=None,
    seed: int = 0,
    device=None,
):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return serve_config(cfg, batch=batch, prompt_len=prompt_len, gen_tokens=gen_tokens,
                        movement=movement, mesh_shape=mesh_shape, seed=seed, device=device)


def serve_config(
    cfg,
    *,
    batch: int = 4,
    prompt_len: int = 64,
    gen_tokens: int = 32,
    movement: str = "daemon",
    mesh_shape=None,
    seed: int = 0,
    device=None,
):
    """``serve`` on a ``ModelConfig``: random weights from ``seed``, a random
    prompt, prefill, then greedy decode."""
    dev = devices.resolve(device)
    if mesh_shape is not None and tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh {mesh_shape}: the port serves on one device until ROADMAP item \"Sharding\""
        )
    specs = M.model_specs(cfg)

    gen = torch.Generator(device=dev).manual_seed(seed)
    if movement == "daemon":
        # serving never reads the f32 master: each leaf is copied as it is
        # drawn, so the master never sits beside the copy (deepseek-v2-lite's
        # would not fit beside it on one 80 GB card)
        params = mv.init_working_copy(specs, gen, dev, mv.DAEMON_DEFAULT)
    else:
        params = nn.init_params(specs, gen, dev)

    rng = np.random.default_rng(seed)
    total_len = prompt_len + gen_tokens
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    batch_in = {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device=dev)}
    batch_in.update(M.stub_inputs(cfg, batch_in["tokens"]))
    prefix = cfg.num_prefix_tokens if cfg.family == "vlm" else 0

    # prefill builds a cache sized for the prompt; decode appends in a cache
    # sized total_len: re-home the prefill cache into the bigger buffers
    prefill = steps_lib.make_prefill_step(cfg)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch_in)
    devices.synchronize(dev)
    t_prefill = time.perf_counter() - t0

    cache = _grow_cache(cfg, cache, total_len)
    decode = steps_lib.make_decode_step(cfg)

    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        tok, logits, cache = decode(params, cache, tok, prompt_len + prefix + i)
        out_tokens.append(tok)
    devices.synchronize(dev)
    t_decode = time.perf_counter() - t0
    toks = torch.stack(out_tokens, dim=1).cpu().numpy()
    return {
        "tokens": toks,
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(gen_tokens - 1, 1),
        "tokens_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
    }


def _grow_cache(cfg, cache, total_len: int):
    """Pad the seq dim (axis 2: [L or invocations, B, S, ...]) of the self-
    attention cache buffers up to total_len, the text tokens of prompt and
    generation.  A VLM's cache also holds its ``num_prefix_tokens`` patch
    positions in front, and grows to prefix + total_len: decode writes at
    prompt_len + prefix + i.  JAX's ``_grow_cache`` grows it to total_len,
    so its decode wraps (slot = pos % length) onto the first patches' K/V.
    An audio cache's cross K/V (``ck``, ``cv``: the encoder's frames) stay
    at the frame count; JAX's pads them with zero keys, which its decode
    attends to (the cross-attention has no ``kv_len``).  An SWA cache is a ring of at most ``window`` slots: one
    already ``window`` long stays put, and a shorter one (a prompt shorter
    than the window) grows to ``min(window, total_len)``, not to total_len,
    so decode keeps attending inside the window.  Its slots 0..prompt_len-1
    already hold those positions (slot = pos % w), and decode's ring mask
    drops the empty ones.  JAX's ``_grow_cache`` pads such a cache to
    total_len, and its decode then attends past the window.  An SSM cache (a
    ``{"state", "conv"}`` dict: the recurrent state and the conv tail) has no
    seq dim and is left alone, as the docstring of JAX's ``_grow_cache``
    intends; its code pads the conv tail, and decode then fails."""
    if cfg.family == "vlm":
        total_len += cfg.num_prefix_tokens
    target = min(cfg.window, total_len) if cfg.attn_kind == "swa" else total_len

    def grow(x):
        if x.dim() < 4:
            return x
        if x.shape[2] < target:
            out = x.new_zeros((*x.shape[:2], target, *x.shape[3:]))
            out[:, :, :x.shape[2]] = x
            return out
        return x

    def walk(tree):
        if isinstance(tree, dict):
            if set(tree) == {"state", "conv"}:
                return tree
            return {k: v if k in ("ck", "cv") else walk(v) for k, v in tree.items()}
        return grow(tree)

    return walk(cache)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--movement", default="daemon", choices=["baseline", "daemon"])
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args()
    r = serve(
        a.arch, reduced=a.reduced, batch=a.batch, prompt_len=a.prompt_len,
        gen_tokens=a.gen, movement=a.movement, device=a.device,
    )
    print(
        f"prefill {r['prefill_s']:.2f}s; decode {r['decode_s_per_token']*1e3:.1f} ms/tok; "
        f"{r['tokens_per_s']:.1f} tok/s; generated shape {r['tokens'].shape}"
    )


if __name__ == "__main__":
    main()
