"""Public block-quantization entry points (port of
``repro.kernels.block_quant.ops``).

Any shape flattens to 2-D (rows, C) and quantizes per block along the last
axis.  A CUDA tensor goes to the Hopper kernel (K1/K2), which takes only
``block == 128``; anything else it raises on.  A CPU tensor, which the caller
asked for, takes the plain version in ``ref.py``.  A fake CUDA tensor (a dry
run) gets empty outputs and its launch reported with :func:`cost`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.block_quant import kernel, ref
from repro_torch.kernels.block_quant.kernel import BLOCK


def quantize(x: torch.Tensor, block: int = BLOCK):
    """x: (..., C) -> (q int8 (..., C), scales f32 (..., C/block))."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x2.is_cuda and block != BLOCK:
        raise ValueError(f"the CUDA kernel quantizes {BLOCK}-element blocks, got {block}")
    if runtime.dry(x2):
        q, s = _dry_quantize(x2)
    elif x2.is_cuda:
        q, s = kernel.quantize(x2.contiguous())
    else:
        q, s = ref.quantize_ref(x2, block)
    return q.reshape(shape), s.reshape(*shape[:-1], shape[-1] // block)


def dequantize(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    shape = q.shape
    q2 = q.reshape(-1, shape[-1])
    s2 = scales.reshape(q2.shape[0], -1)
    if q2.is_cuda and q2.shape[-1] != s2.shape[-1] * BLOCK:
        raise ValueError(f"the CUDA kernel dequantizes {BLOCK}-element blocks")
    if runtime.dry(q2, s2):
        x = torch.empty(q2.shape, dtype=dtype, device=q2.device)
        _dry_launch("block_quant.dequantize", q2.numel(), x.element_size())
    elif q2.is_cuda:
        x = kernel.dequantize(q2.contiguous(), s2.contiguous(), dtype)
    else:
        x = ref.dequantize_ref(q2, s2, dtype)
    return x.reshape(shape)


def _dry_quantize(x2: torch.Tensor):
    """K1's outputs, empty, for a dry run, and its launch reported."""
    if x2.shape[-1] % BLOCK:
        raise ValueError(f"last dim {x2.shape[-1]} is not a multiple of {BLOCK}")
    q = torch.empty(x2.shape, dtype=torch.int8, device=x2.device)
    s = torch.empty((x2.shape[0], x2.shape[1] // BLOCK), dtype=torch.float32, device=x2.device)
    _dry_launch("block_quant.quantize", x2.numel(), x2.element_size())
    return q, s


def _dry_launch(name: str, n: int, float_bytes: int) -> None:
    if n:  # as the kernels, no launch for no block
        flops, n_bytes = cost(name.split(".")[1], n, float_bytes)
        runtime.dry_launch(name, flops=flops, bytes=n_bytes)


def cost(kind: str, n: int, float_bytes: int = 4):
    """(FLOP, bytes) of one K1 (``kind="quantize"``) or K2 (``"dequantize"``)
    launch over ``n`` elements whose float side (K1's input, K2's output) has
    ``float_bytes`` bytes an element: each input read once and each output
    written once, int8 codes and one f32 scale a 128-block.  K1 does 5 FLOP an
    element (the capture shim's count), K2 one product.  Both are bound by
    their bytes."""
    scale_bytes = 4 * n // BLOCK
    if kind == "quantize":
        return 5 * n, float_bytes * n + n + scale_bytes
    if kind == "dequantize":
        return n, n + scale_bytes + float_bytes * n
    raise ValueError(f"kind must be 'quantize' or 'dequantize', got {kind!r}")


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
