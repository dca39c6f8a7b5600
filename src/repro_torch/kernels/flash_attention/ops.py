"""Public flash-attention entry point (port of
``repro.kernels.flash_attention.ops``): the Hopper kernel K3 for CUDA
tensors, which raises on what it does not take; the plain version in
``ref.py`` for CPU tensors, which the caller asked for."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in q's dtype.
    Forward only on the card, as the Pallas kernel is: a CUDA call that
    autograd would have to differentiate raises (training attends through
    ``models.nn.attention``)."""
    if q.is_cuda:
        runtime.forward_only("flash_attention (K3)", q, k, v)
        return kernel.forward(q, k, v, causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


# K3's bf16 launch (flash_forward_wgmma_kernel<D>), as csrc/flash_attention.cu
# sets it: 128 q rows a CTA, 64-key K/V tiles in a 4-stage TMA ring, 288
# threads (two consumer warpgroups and a producer warp); one CTA an SM, which
# chip_smoke.py holds to the card's occupancy query.  tests/test_torch_capture.py
# reads the constants from the source.
TC_BQ, TC_BK, TC_STAGES, TC_THREADS = 128, 64, 4, 288
TC_CTAS_PER_SM = 1


def trace_geometry(*, b: int, sq: int, skv: int, h: int, kvh: int, d: int,
                   causal: bool = True, window: int = 0, variant: str = "prefill"):
    """Capture shim: K3's bf16 launch for q (B, Sq, H, D), k/v (B, Skv, KVH,
    D) as a :class:`~repro_torch.capture.geometry.CtaGeometry`.

    Grid (ceil(Sq/128), H, B); CTA x takes the q tile at
    ``(gridDim.x - 1 - x) * 128`` (heaviest first) and walks the 64-key tiles
    in ``[k_lo, k_hi)`` of its band (causal: keys up to the tile's last row,
    the mask aligned top-left; window: from its first row's window), one step
    a tile.  Its first step issues the q tile and the ring's first 4 K/V
    tiles, each later step one K/V pair.  Q stays in registers; o is written
    once, at the last step.  Tiles are ``(1, rows, 1, D)`` boxes of the
    ``(B, S, heads, D)`` bf16 arrays: ``rows`` strided runs of ``2·D`` bytes,
    clipped at Sq and Skv as the TMA clips them.  (The TMA moves a tile as
    D/8 column slabs; the model emits each line of the box once, row by
    row.)  A step is 4·128·64·D FLOP at the bf16 tensor-core peak."""
    from repro_torch.capture.geometry import CtaGeometry, CtaOperand

    if h % kvh:
        raise ValueError(f"heads {h} are not a multiple of kv heads {kvh}")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {kernel.HEAD_DIMS}")
    group = h // kvh
    gx = -(-sq // TC_BQ)

    def band(x: int):
        """(first KV tile, KV tiles) of CTA x, as the kernel computes them."""
        q0 = (gx - 1 - x) * TC_BQ
        k_hi = min(skv, q0 + TC_BQ) if causal else skv
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        t_lo = k_lo // TC_BK
        return t_lo, max(0, -(-k_hi // TC_BK) - t_lo)

    bands = [band(x) for x in range(gx)]
    if any(n == 0 for _, n in bands):
        raise ValueError("a q tile sees no key: a CTA without a KV tile is not modelled")

    def q_map(cta, step):
        x, head, row = cta
        return (row, gx - 1 - x, head, 0)

    def kv_map(cta, step):
        x, head, row = cta
        return (row, bands[x][0] + step, head // group, 0)

    bf16 = {"elem_bytes": 2, "payload": "bf16_dense"}
    return CtaGeometry(
        kernel="flash_attention", variant=variant, grid=(gx, h, b),
        threads=TC_THREADS, ctas_per_sm=TC_CTAS_PER_SM,
        operands=(
            CtaOperand("q", (b, sq, h, d), (1, TC_BQ, 1, d), q_map, **bf16),
            CtaOperand("k", (b, skv, kvh, d), (1, TC_BK, 1, d), kv_map,
                       ahead=TC_STAGES - 1, **bf16),
            CtaOperand("v", (b, skv, kvh, d), (1, TC_BK, 1, d), kv_map,
                       ahead=TC_STAGES - 1, **bf16),
            CtaOperand("o", (b, sq, h, d), (1, TC_BQ, 1, d), q_map, is_output=True, **bf16),
        ),
        steps=tuple(bands[x][1] for _ in range(b) for _ in range(h) for x in range(gx)),
        flops_per_step=4.0 * TC_BQ * TC_BK * d, flop_unit="tensor",
    )
