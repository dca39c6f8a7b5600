"""Public flash-attention entry points (port of
``repro.kernels.flash_attention.ops``): the Hopper kernel K3 for CUDA
tensors, which raises on what it does not take; the plain version in
``ref.py`` for CPU tensors, which the caller asked for.  A fake CUDA tensor
(a dry run) gets an empty output and its launch reported with :func:`cost`.

Training on the card has its own entry, :func:`flash_attention_train`: K3's
training instance forward (o and each row's log-sum-exp) and K5's backward,
as one autograd function.  :func:`trains` says which inputs take it; the
others attend through ``models.nn.attention``."""
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


def trains(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether training attention on these inputs goes through the kernels
    (:func:`flash_attention_train`): plain CUDA tensors (a dry run's fake
    ones too), not DTensors, all bfloat16, one head_dim that the training
    instances have.  Everything else (the CPU, DTensors, f32, other head
    dims, MLA's q/k 192 against v 128) attends through ``nn.attention``."""
    from repro_torch.models.nn import is_dtensor

    ts = (q, k, v)
    return (not any(is_dtensor(t) for t in ts)
            and all(t.is_cuda and t.dtype == torch.bfloat16 for t in ts)
            and q.shape[-1] == k.shape[-1] == v.shape[-1]
            and q.shape[-1] in kernel.TRAIN_HEAD_DIMS)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Training attention on the card: q (B, Sq, H, D), k, v (B, Skv, KVH,
    D), bf16 CUDA tensors -> o (B, Sq, H, D) bf16, differentiable.  The
    forward is K3's training instance (it saves q, k, v, o and lse); the
    backward is K5 (dq, then dk and dv).  Masking as :func:`flash_attention`:
    causal (``kpos <= qpos``) and ``kpos > qpos - window`` when
    ``window > 0``."""
    return _FlashTrain.apply(q, k, v, causal, window)


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if runtime.dry(q, k, v):
            _dry_launches(q, k, ("flash_attention.train_forward",), causal, window)
            b, sq, h, _ = q.shape
            o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        else:
            o, lse = kernel.train_forward(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = _backward_dq(q, k, v, o, lse, do, ctx.causal, ctx.window)
        dk, dv = _backward_dkdv(q, k, v, do, lse, delta, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def _backward_dq(q, k, v, o, lse, do, causal: bool, window: int):
    """(dq, delta): K5's first kernel, or on a dry run its launch reported."""
    if runtime.dry(q, k, v):
        _dry_launches(q, k, ("flash_attention_bwd.dq",), causal, window)
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty(lse.shape, dtype=torch.float32, device=q.device))
    return kernel.backward_dq(q, k, v, o, lse, do, causal=causal, window=window)


def _backward_dkdv(q, k, v, do, lse, delta, causal: bool, window: int):
    """(dk, dv): K5's second kernel, or on a dry run its launch reported."""
    if runtime.dry(q, k, v):
        _dry_launches(q, k, ("flash_attention_bwd.dkdv",), causal, window)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        return dk, torch.empty_like(dk)
    return kernel.backward_dkdv(q, k, v, do, lse, delta, causal=causal, window=window)


def _dry_launches(q, k, names, causal: bool, window: int) -> None:
    b, sq, h, d = q.shape
    if q.numel() == 0:
        return
    for name in names:
        flops, n_bytes = train_cost(name, b=b, sq=sq, skv=k.shape[1], h=h, kvh=k.shape[2],
                                    d=d, causal=causal, window=window)
        runtime.dry_launch(name, flops=flops, bytes=n_bytes)


# tensor-core products of 2·D FLOP a kept (q, k) pair and q head that each
# training launch issues, P and dS counted twice (hi + lo); and the (B, S,
# heads, D) bf16 tensors it reads and writes (q-shaped, k-shaped), and the
# (B, H, Sq) f32 rows (lse, delta)
_TRAIN_WORK = {
    # S = Q K^T, O += P_hi V + P_lo V; reads q, k, v, writes o and lse
    "flash_attention.train_forward": (3, 2, 2, 1),
    # S, dP = dO V^T, dQ += dS_hi K + dS_lo K; reads q, k, v, o, dO, lse,
    # writes dq and delta
    "flash_attention_bwd.dq": (4, 4, 2, 2),
    # S^T, dP^T, dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q;
    # reads q, k, v, dO, lse and delta, writes dk and dv
    "flash_attention_bwd.dkdv": (6, 2, 4, 2),
}


def train_cost(name: str, *, b: int, sq: int, skv: int, h: int, kvh: int, d: int,
               causal: bool = True, window: int = 0):
    """(FLOP, bytes) of one training launch ``name`` (a ``runtime.LAUNCHES``
    key): the tensor-core products as the kernel issues them, over the kept
    (q, k) pairs, and each tensor it reads or writes counted once."""
    products, q_like, k_like, rows = _TRAIN_WORK[name]
    flops = products * 2 * d * b * h * band_pairs(sq, skv, causal, window)
    n_bytes = 2 * (q_like * b * sq * h * d + k_like * b * skv * kvh * d) + 4 * rows * b * h * sq
    return flops, n_bytes


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
