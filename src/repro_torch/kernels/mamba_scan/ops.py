"""Public selective-scan entry point (port of
``repro.kernels.mamba_scan.ops``): the Hopper kernel K4 for CUDA tensors,
which raises on what it does not take; the plain version in ``ref.py`` for
CPU tensors, which the caller asked for.  Fake CUDA tensors (a dry run) get
empty outputs and their launch reported with :func:`cost`."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.mamba_scan import kernel, ref


def selective_scan(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   x: torch.Tensor):
    """dt, x: (B, S, D); a: (D, N); bmat, cmat: (B, S, N) ->
    (y (B, S, D) f32, h_last (B, D, N) f32).  Forward only on the card, as
    the Pallas kernel is: a CUDA call that autograd would have to
    differentiate raises.  DTensors (a sharded model) are scanned on each
    rank's local batch rows and channels (:func:`_sharded`)."""
    from repro_torch.models.nn import is_dtensor

    if is_dtensor(dt):
        return _sharded(dt, a, bmat, cmat, x)
    if runtime.dry(dt, a, bmat, cmat, x):
        runtime.forward_only("selective_scan (K4)", dt, a, bmat, cmat, x)
        b, s, d = dt.shape
        n = a.shape[1]
        if n not in kernel.STATE_DIMS:
            raise ValueError(f"state dim N={n} not in the kernel's {kernel.STATE_DIMS}")
        if dt.numel():
            flops, n_bytes = cost(b=b, s=s, d=d, n=n, x_bytes=x.element_size())
            runtime.dry_launch("mamba_scan.forward", flops=flops, bytes=n_bytes)
        return (torch.empty((b, s, d), dtype=torch.float32, device=dt.device),
                torch.empty((b, d, n), dtype=torch.float32, device=dt.device))
    if dt.is_cuda:
        runtime.forward_only("selective_scan (K4)", dt, a, bmat, cmat, x)
        return kernel.forward(dt, a, bmat, cmat, x)
    return ref.selective_scan_ref(dt, a, bmat, cmat, x)


def cost(*, b: int, s: int, d: int, n: int, x_bytes: int = 2):
    """(FLOP, bytes) of one K4 launch on dt, x (B, S, D), A (D, N), B/C
    (B, S, N): 8 FLOP a state update (the Pallas shim's count), and dt (f32),
    x (``x_bytes``), B, C and A read once, y and h_last (f32) written once."""
    flops = 8 * b * s * d * n
    n_bytes = (4 + x_bytes + 4) * b * s * d + 2 * 4 * b * s * n + 4 * d * n + 4 * b * d * n
    return flops, n_bytes


def _sharded(dt, a, bmat, cmat, x):
    """K4 on DTensors: dt and x keep their batch (dim 0) and channel (dim 2)
    shards, A is split over its channels as they are, B and C keep only the
    batch shards; each rank scans its local rows and channels."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.runtime.sharding import from_block, with_placements

    mesh = dt.device_mesh
    xpl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                for p in dt.placements)
    apl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xpl)
    bpl = tuple(p if p == Shard(0) else Replicate() for p in xpl)
    hpl = tuple(Shard(1) if p == Shard(2) else p for p in xpl)
    dt, x = with_placements(dt, mesh, xpl), with_placements(x, mesh, xpl)
    a = with_placements(a, mesh, apl)
    bmat, cmat = with_placements(bmat, mesh, bpl), with_placements(cmat, mesh, bpl)
    y, h = selective_scan(*(t.to_local().contiguous() for t in (dt, a, bmat, cmat, x)))
    b, s, d = dt.shape
    n = a.shape[1]
    return from_block(y, mesh, xpl, (b, s, d)), from_block(h, mesh, hpl, (b, d, n))


# K4's launch, as csrc/mamba_scan.cu sets it: 128 threads, two lanes a
# channel, so 64 channels a block; 64 steps a stage in a 3-stage cp.async
# ring; two blocks an SM, which chip_smoke.py holds to the card's occupancy
# query.  tests/test_torch_capture.py reads the constants from the source.
THREADS, LANES, CB, T, STAGES = 128, 2, 64, 64, 3
CTAS_PER_SM = 2


def trace_geometry(*, b: int, s: int, d: int, n: int, variant: str = "fwd"):
    """Capture shim: K4's launch for dt (B, S, D) f32, x (B, S, D) bf16 (as
    the model passes it), A (D, N), B/C (B, S, N) as a
    :class:`~repro_torch.capture.geometry.CtaGeometry`.

    Grid (ceil(D/64), B); a block reads its 64 rows of A once, then stages
    dt, x, B and C 64 steps at a time, two stages ahead of use (B and C again
    in every channel block of the batch row); one step of the model is one
    stage.  y is written in the stage that computes it, h_last at the end.
    Tiles clip at S and D.  A stage is 8·64·64·N FLOP at the f32 CUDA-core
    peak (the Pallas shim's 8 a state update)."""
    from repro_torch.capture.geometry import CtaGeometry, CtaOperand

    if n not in kernel.STATE_DIMS:
        raise ValueError(f"state dim N={n} not in the kernel's {kernel.STATE_DIMS}")
    gx, chunks = -(-d // CB), -(-s // T)

    def chunk_map(cta, step):
        x, row, _ = cta
        return (row, step, x)

    def bc_map(cta, step):
        return (cta[1], step, 0)

    def a_map(cta, step):
        return (cta[0], 0)

    def h_map(cta, step):
        return (cta[1], cta[0], 0)

    ring = STAGES - 1
    return CtaGeometry(
        kernel="mamba_scan", variant=variant, grid=(gx, b, 1),
        threads=THREADS, ctas_per_sm=CTAS_PER_SM,
        operands=(
            CtaOperand("a", (d, n), (CB, n), a_map),
            CtaOperand("dt", (b, s, d), (1, T, CB), chunk_map, ahead=ring, payload="f32_pos"),
            CtaOperand("x", (b, s, d), (1, T, CB), chunk_map, ahead=ring, elem_bytes=2,
                       payload="bf16_dense"),
            CtaOperand("bmat", (b, s, n), (1, T, n), bc_map, ahead=ring),
            CtaOperand("cmat", (b, s, n), (1, T, n), bc_map, ahead=ring),
            CtaOperand("y", (b, s, d), (1, T, CB), chunk_map, is_output=True),
            CtaOperand("h_last", (b, d, n), (1, CB, n), h_map, is_output=True),
        ),
        steps=(chunks,) * (gx * b),
        flops_per_step=8.0 * T * CB * n, flop_unit="cuda",
    )
