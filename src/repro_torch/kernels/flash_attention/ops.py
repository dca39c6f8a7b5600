"""Public flash-attention entry point (port of
``repro.kernels.flash_attention.ops``): the Hopper kernel K3 for CUDA
tensors, which raises on what it does not take; the plain version in
``ref.py`` for CPU tensors, which the caller asked for.  A fake CUDA tensor
(a dry run) gets an empty output and its launch reported with :func:`cost`."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) -> (B, Sq, H, D) in q's dtype.
    Forward only on the card, as the Pallas kernel is: a CUDA call that
    autograd would have to differentiate raises (training attends through
    ``models.nn.attention``).  DTensors (a sharded model) are attended on
    each rank's local batch rows and q heads (:func:`_sharded`)."""
    from repro_torch.models.nn import is_dtensor

    if is_dtensor(q):
        return _sharded(q, k, v, causal=causal, window=window)
    if runtime.dry(q, k, v):
        runtime.forward_only("flash_attention (K3)", q, k, v)
        b, sq, h, d = q.shape
        if d not in kernel.HEAD_DIMS:
            raise ValueError(f"head_dim {d} not in the kernel's {kernel.HEAD_DIMS}")
        if q.numel():
            flops, n_bytes = cost(b=b, sq=sq, skv=k.shape[1], h=h, kvh=k.shape[2], d=d,
                                  causal=causal, window=window, elem_bytes=q.element_size())
            runtime.dry_launch("flash_attention.forward", flops=flops, bytes=n_bytes)
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.is_cuda:
        runtime.forward_only("flash_attention (K3)", q, k, v)
        return kernel.forward(q, k, v, causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def band_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask keeps: the work K3 must do on these inputs."""
    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv - 1, qpos) if causal else np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def cost(*, b: int, sq: int, skv: int, h: int, kvh: int, d: int, causal: bool = True,
         window: int = 0, elem_bytes: int = 2):
    """(FLOP, bytes) of one K3 launch on q (B, Sq, H, D), k/v (B, Skv, KVH, D):
    two products of 2·D FLOP a kept (q, k) pair and q head, and q, k, v read
    once and o written once, ``elem_bytes`` an element."""
    flops = 4 * d * b * h * band_pairs(sq, skv, causal, window)
    n_bytes = elem_bytes * (2 * b * sq * h * d + 2 * b * skv * kvh * d)
    return flops, n_bytes


def _sharded(q, k, v, *, causal: bool, window: int):
    """K3 on DTensors: each rank calls the kernel on its local batch rows and
    q heads, with the KV heads they read (``runtime.sharding.head_shards``)."""
    from repro_torch.runtime.sharding import head_shards

    ql, kl, vl, wrap = head_shards(q, k, v)
    return wrap(flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                causal=causal, window=window))


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
