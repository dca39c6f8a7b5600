"""Measured-from-data compressibility of captured traces (port of
``repro.capture.compress``).

Each operand region is filled with a representative payload, zlib-compressed,
and the per-operand ratios are combined weighted by the bytes each operand
moved in the captured launch.  Payload models:

  f32_dense       dense gaussian f32: attention and SSM streams; barely
                  compresses (high-entropy mantissas).
  bf16_dense      the bf16 rounding (to nearest even) of f32_dense's draw:
                  what K3's bf16 tiles and K4's bf16 x hold.  Its exponent
                  byte is a larger share of each value, so it compresses
                  more than f32_dense; calling it f32 would misstate both
                  the bytes and the ratio.
  f32_act_sparse  gate-sparsified heavy-tailed f32 activations (~40 % zeros,
                  student-t(3)): block_quant's input.
  f32_pos         softplus-positive small values: SSM steps dt.
  f32_scales      per-block absmax scales.
  int8_quant      per-128-block absmax int8 codes of f32_act_sparse's kind.

Everything is seeded and sample-capped (1 MiB an operand), so a measurement
is deterministic and cheap.
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

from repro_torch.capture.recorder import CaptureResult

SAMPLE_BYTES = 1 << 20  # per-operand measurement sample cap (1 MiB)
_QBLOCK = 128  # absmax quantization block (block_quant's BLOCK)


def _sparse_heavy(rng: np.random.Generator, n: int) -> np.ndarray:
    """Student-t(3) values with ~40 % exact zeros (GLU gating, padding)."""
    x = rng.standard_t(3, n).astype(np.float32)
    x[rng.random(n) < 0.4] = 0.0
    return x


def _rng(payload: str, seed: int) -> np.random.Generator:
    return np.random.default_rng((seed, zlib.crc32(payload.encode())))


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bf16 bit patterns of finite f32 values, rounded to nearest even."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def payload_bytes(payload: str, n_bytes: int, seed: int = 0) -> bytes:
    """Representative region contents for one payload model."""
    if payload == "bf16_dense":
        x = _rng("f32_dense", seed).standard_normal(max(1, n_bytes // 2)).astype(np.float32)
        return _bf16_bits(x).tobytes()[:n_bytes]
    rng = _rng(payload, seed)
    if payload == "int8_quant":
        n = max(_QBLOCK, n_bytes // _QBLOCK * _QBLOCK)
        x = _sparse_heavy(rng, n).reshape(-1, _QBLOCK)
        s = np.abs(x).max(axis=1, keepdims=True) / 127.0
        s[s == 0] = 1.0
        return np.clip(np.round(x / s), -127, 127).astype(np.int8).tobytes()[:n_bytes]
    n = max(1, n_bytes // 4)
    if payload == "f32_act_sparse":
        x = _sparse_heavy(rng, n)
    elif payload == "f32_pos":
        x = np.log1p(np.exp(rng.standard_normal(n) * 0.5 - 2)).astype(np.float32)
    elif payload == "f32_scales":
        base = np.abs(rng.standard_t(3, (n // 8 + 1, 8))).max(axis=1) / 127.0
        x = np.repeat(base, 8)[:n].astype(np.float32)
    else:  # f32_dense
        x = rng.standard_normal(n).astype(np.float32)
    return x.tobytes()[:n_bytes]


def measure_ratio(payload: str, n_bytes: int = SAMPLE_BYTES, seed: int = 0) -> float:
    raw = payload_bytes(payload, n_bytes, seed)
    return max(1.0, len(raw) / len(zlib.compress(raw, 6)))


def measured_compressibility(cap: CaptureResult, seed: int = 0) -> float:
    """Bytes-moved-weighted mean compression ratio over the capture's operand
    regions: the one ratio a workload gives the link-compression model."""
    ops = {op.name: op for op in cap.geom.operands}
    ratios: Dict[str, float] = {}
    total = 0.0
    acc = 0.0
    for name, moved in cap.moved_bytes.items():
        if moved <= 0:
            continue
        op = ops[name]
        r = ratios.get(op.payload)
        if r is None:
            r = ratios[op.payload] = measure_ratio(
                op.payload, min(SAMPLE_BYTES, max(4096, op.nbytes)), seed)
        acc += moved * r
        total += moved
    return acc / total if total else 1.0
