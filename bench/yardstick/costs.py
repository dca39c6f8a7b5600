"""The benchmark's frozen yardstick: the operations and bytes of the work a
cell asks for, computed from shapes alone, and the table of peaks.

These are copies, frozen here so that a change to a kernel cannot also
change the ruler it is read against: ``band_pairs`` and ``k3_cost`` from the
port's ``kernels/flash_attention/ops.py``, ``bq_cost`` from
``kernels/block_quant/ops.py``, ``train_flop`` from ``chip_smoke.py`` (its
dense-family case).  Parameter shapes come from the benchmark's own
configuration files (``harness.config.param_shapes``).
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from bench.harness.config import foldable, page_class, param_shapes

BLOCK = 128  # K1/K2's block: one f32 scale a 128-element run of the last dim


def peaks(device_kind: str):
    """The published peaks of ``device_kind`` ({"bf16_flop_per_s",
    "hbm_bytes_per_s"}), or None for a device the table lacks."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return table.get(device_kind)


def band_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask keeps: positions count from 0 for q and k, a
    causal mask keeps k <= q, a window keeps k > q - window."""
    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv - 1, qpos) if causal else np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def k3_cost(*, b: int, sq: int, skv: int, h: int, kvh: int, d: int, causal: bool = True,
            window: int = 0, elem_bytes: int = 2):
    """(FLOP, bytes) of attention over q (B, Sq, H, D), k/v (B, Skv, KVH, D):
    two products of 2·D FLOP a kept pair and q head; q, k, v read once and o
    written once."""
    flops = 4 * d * b * h * band_pairs(sq, skv, causal, window)
    n_bytes = elem_bytes * (2 * b * sq * h * d + 2 * b * skv * kvh * d)
    return flops, n_bytes


def bq_cost(kind: str, n: int, float_bytes: int = 4):
    """(FLOP, bytes) of one K1 (``"quantize"``) or K2 (``"dequantize"``) call
    over ``n`` elements whose float side has ``float_bytes`` bytes an
    element: each input read once, each output written once, int8 codes and
    one f32 scale a block."""
    scale_bytes = 4 * n // BLOCK
    if kind == "quantize":
        return 5 * n, float_bytes * n + n + scale_bytes
    if kind == "dequantize":
        return n, n + scale_bytes + float_bytes * n
    raise ValueError(f"kind must be 'quantize' or 'dequantize', got {kind!r}")


def bq_step_calls(cfg: dict, movement: dict):
    """The K1/K2 calls of one DaeMon training step, as [(kind, n, float
    bytes)]: with int8 gradients each foldable gradient (ndim >= 2, last dim
    a multiple of 128) is quantised from f32 and dequantised to f32; with
    int8 page-class weights each stacked weight (ndim >= 3) of the new
    working copy is quantised from the f32 master and dequantised to bf16."""
    calls = []
    for shape in param_shapes(cfg).values():
        n = math.prod(shape)
        if movement.get("grad_sync") == "int8" and foldable(shape):
            calls += [("quantize", n, 4), ("dequantize", n, 4)]
        if movement.get("expert_weights") == "int8" and page_class(shape):
            calls += [("quantize", n, 4), ("dequantize", n, 2)]
    return calls


def attention_shape(cfg: dict):
    """(heads, kv heads, head size, window) of the configuration."""
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return h, kvh, cfg["hidden_size"] // h, cfg.get("sliding_window") or 0


def train_flop(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOP of one training step: 6 a token for each parameter (forward
    2, backward 4), plus attention's QK^T and PV products, 2·B·H·2·D a kept
    (q, k) pair, three times over (forward and backward), in every layer.
    The recompute of a rematerialised layer is not counted."""
    n = sum(math.prod(s) for s in param_shapes(cfg).values())
    h, _, d, window = attention_shape(cfg)
    pairs = band_pairs(seq, seq, True, window)
    attention = 3 * 2 * (d + d) * batch * h * pairs * cfg["num_hidden_layers"]
    return 6 * n * batch * seq + attention


def prefill_flop(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOP of one prefill of ``batch`` prompts of ``seq`` tokens that
    returns the last position's logits: 2 a token for each weight of the
    layers, the head's product for the last position only, and attention's
    two products over the kept pairs of every layer."""
    shapes = param_shapes(cfg)
    layer_weights = sum(math.prod(s) for k, s in shapes.items()
                        if k.startswith("seg0/") and len(s) == 3)
    head = cfg["hidden_size"] * cfg["vocab_size"]
    h, kvh, d, window = attention_shape(cfg)
    attn, _ = k3_cost(b=batch, sq=seq, skv=seq, h=h, kvh=kvh, d=d, causal=True, window=window)
    return 2 * layer_weights * batch * seq + 2 * head * batch + attn * cfg["num_hidden_layers"]
