"""Public block-quantization entry points (port of
``repro.kernels.block_quant.ops``).

Any shape flattens to 2-D (rows, C) and quantizes per block along the last
axis.  A CUDA tensor goes to the Hopper kernel (K1/K2), which takes only
``block == 128``; anything else it raises on.  A CPU tensor, which the caller
asked for, takes the plain version in ``ref.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.block_quant import kernel, ref
from repro_torch.kernels.block_quant.kernel import BLOCK


def quantize(x: torch.Tensor, block: int = BLOCK):
    """x: (..., C) -> (q int8 (..., C), scales f32 (..., C/block))."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x2.is_cuda:
        if block != BLOCK:
            raise ValueError(f"the CUDA kernel quantizes {BLOCK}-element blocks, got {block}")
        q, s = kernel.quantize(x2.contiguous())
    else:
        q, s = ref.quantize_ref(x2, block)
    return q.reshape(shape), s.reshape(*shape[:-1], shape[-1] // block)


def dequantize(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    shape = q.shape
    q2 = q.reshape(-1, shape[-1])
    s2 = scales.reshape(q2.shape[0], -1)
    if q2.is_cuda:
        if q2.shape[-1] != s2.shape[-1] * BLOCK:
            raise ValueError(f"the CUDA kernel dequantizes {BLOCK}-element blocks")
        x = kernel.dequantize(q2.contiguous(), s2.contiguous(), dtype)
    else:
        x = ref.dequantize_ref(q2, s2, dtype)
    return x.reshape(shape)


def wire_bytes(shape, dtype_bytes: int = 2, block: int = BLOCK) -> int:
    """Compressed wire size: int8 payload + f32 scale per block."""
    n = int(np.prod(shape))
    return n + 4 * (n // block)


# K1's launch, as csrc/block_quant.cu sets it: one warp a 128-element block,
# 8 warps (256 threads) a CTA; 8 CTAs an SM, which chip_smoke.py holds to the
# card's occupancy query.  tests/test_torch_capture.py reads the constants
# from the source.
WARPS_PER_CTA = 8
CTAS_PER_SM = 8


def trace_geometry(*, r: int, c: int, variant: str = "quant"):
    """Capture shim: K1's launch for an (R, C) f32 input as a
    :class:`~repro_torch.capture.geometry.CtaGeometry`.  The kernel sees x,
    q and the scales as flat arrays; grid ceil(R·C/128/8), one step a CTA:
    it reads 8 contiguous 128-element blocks (1024 f32, clipped at the end)
    and writes their 1 KiB of int8 codes and 8 f32 scales.  A step is 5·1024
    FLOP at the f32 CUDA-core peak."""
    from repro_torch.capture.geometry import CtaGeometry, CtaOperand

    if c % BLOCK:
        raise ValueError(f"C={c} must be a multiple of {BLOCK}")
    n_blocks = r * c // BLOCK
    per_cta = WARPS_PER_CTA * BLOCK
    gx = -(-n_blocks // WARPS_PER_CTA)

    def flat_map(cta, step):
        return (cta[0],)

    return CtaGeometry(
        kernel="block_quant", variant=variant, grid=(gx, 1, 1),
        threads=WARPS_PER_CTA * 32, ctas_per_sm=CTAS_PER_SM,
        operands=(
            CtaOperand("x", (r * c,), (per_cta,), flat_map, payload="f32_act_sparse"),
            CtaOperand("q", (r * c,), (per_cta,), flat_map, elem_bytes=1, is_output=True,
                       payload="int8_quant"),
            CtaOperand("scales", (n_blocks,), (WARPS_PER_CTA,), flat_map, is_output=True,
                       payload="f32_scales"),
        ),
        steps=(1,) * gx, flops_per_step=5.0 * per_cta, flop_unit="cuda",
    )
