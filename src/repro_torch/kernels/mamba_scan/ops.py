"""Public selective-scan entry point (port of
``repro.kernels.mamba_scan.ops``): the Hopper kernel K4 for CUDA tensors,
which raises on what it does not take; the plain version in ``ref.py`` for
CPU tensors, which the caller asked for."""
from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.mamba_scan import kernel, ref


def selective_scan(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   x: torch.Tensor):
    """dt, x: (B, S, D); a: (D, N); bmat, cmat: (B, S, N) ->
    (y (B, S, D) f32, h_last (B, D, N) f32).  Forward only on the card, as
    the Pallas kernel is: a CUDA call that autograd would have to
    differentiate raises."""
    if dt.is_cuda:
        runtime.forward_only("selective_scan (K4)", dt, a, bmat, cmat, x)
        return kernel.forward(dt, a, bmat, cmat, x)
    return ref.selective_scan_ref(dt, a, bmat, cmat, x)


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
