"""DaeMon collective primitives on ``torch.distributed`` (port of
``repro.core.movement.collectives``):

  compressed_all_gather     link compression on page-granularity moves:
                            per-block int8 quantize -> gather -> dequantize
                            (wire ~1.94x smaller than bf16, ~3.9x vs f32)
  compressed_grad_sync      mean-reduce with int8 link compression and ERROR
                            FEEDBACK (the residual re-enters the next step's
                            gradient, so compression error does not
                            accumulate)
  chunked_all_gather        decoupled dual-granularity movement: the
                            critical rows (needed now) are gathered first and
                            uncompressed, then the page chunks follow
                            compressed, issued asynchronously and waited on
                            only when they are concatenated.

JAX runs these inside ``shard_map`` over a named mesh axis; here each
function takes this rank's shard and a process ``group`` (default: the world)
and returns what the JAX function returns inside ``shard_map``.  The int8
codes and f32 scales cross the wire; on CUDA tensors (an NCCL group) the
quantize and dequantize are kernels K1 and K2, on CPU tensors (a gloo group)
their plain versions (``kernels.block_quant.ops``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.block_quant import ops as bq
from repro_torch.kernels.block_quant.ops import BLOCK


def _flatten_pad(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """x flattened and zero-padded to a multiple of ``multiple`` elements."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def _gather(t: torch.Tensor, group) -> Tuple[torch.Tensor, Callable[[], None]]:
    """Start gathering ``t`` over ``group`` along dim 0 (tiled): the output
    buffer and the function that waits for it."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    work = dist.all_gather_into_tensor(out, t.contiguous(), group=group, async_op=True)
    return out, work.wait


def _start_gather(x: torch.Tensor, group, compress: Optional[str],
                  tiled: bool = True) -> Callable[[], torch.Tensor]:
    """Issue the gather of ``x`` compressed as ``compress``; return the
    function that waits for it and decodes what arrived."""
    n = dist.get_world_size(group)
    if compress is None or compress == "none" or compress == "bf16":
        out, wait = _gather(x.to(torch.bfloat16) if compress == "bf16" else x, group)

        def finish() -> torch.Tensor:
            wait()
            g = out.to(x.dtype)
            return g if tiled else g.reshape(n, *x.shape)

        return finish
    if compress != "int8":
        raise ValueError(f"compress must be none, bf16 or int8, got {compress!r}")
    xf = _flatten_pad(x, BLOCK).reshape(-1, BLOCK)
    q, s = bq.quantize(xf)
    (qg, wait_q), (sg, wait_s) = _gather(q, group), _gather(s, group)

    def finish() -> torch.Tensor:
        wait_q()
        wait_s()
        full = bq.dequantize(qg, sg, x.dtype).reshape(n, -1)[:, : x.numel()]
        return full.reshape((n * x.shape[0],) + tuple(x.shape[1:]))

    return finish


def compressed_all_gather(x: torch.Tensor, group=None, *, compress: Optional[str] = "int8",
                          tiled: bool = True) -> torch.Tensor:
    """All-gather x's leading dim over ``group``; the payload on the wire is
    int8 + per-128-block f32 scales when compress='int8' (which, as in JAX,
    always returns the tiled shape)."""
    return _start_gather(x, group, compress, tiled)()


def compressed_grad_sync(g: torch.Tensor, group=None, residual: Optional[torch.Tensor] = None,
                         *, compress: Optional[str] = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce g over ``group`` with link compression + error feedback.

    Returns (g_mean, new_residual).  Each rank quantizes its gradient once,
    ships 1/n of it to every peer (all-to-all of int8 codes and f32 scales),
    takes the f32 mean of the n dequantized contributions to its own slice,
    then all-gathers the reduced slices, int8 again.  The residual holds what
    the first quantization dropped; it is added back before the next one."""
    n = dist.get_world_size(group)
    if compress in (None, "none", "bf16"):
        dt = torch.bfloat16 if compress == "bf16" else g.dtype
        total = g.to(dt, copy=True)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total / n).to(g.dtype), torch.zeros((), dtype=g.dtype, device=g.device)
    if compress != "int8":
        raise ValueError(f"compress must be none, bf16 or int8, got {compress!r}")
    if residual is not None and residual.dim() == g.dim():
        g = g + residual.to(g.dtype)

    flat = _flatten_pad(g, BLOCK * n)  # shard s of it goes to peer s
    q, s = bq.quantize(flat.reshape(-1, BLOCK))
    # error feedback: what int8 dropped, fed back next step
    deq_local = bq.dequantize(q, s, torch.float32)
    new_res = (flat - deq_local.reshape(-1))[: g.numel()].reshape(g.shape).to(torch.float32)

    # ship int8 shards: peer s receives shard s of every rank
    qt, st = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(qt, q, group=group)
    dist.all_to_all_single(st, s, group=group)
    # this rank now holds the n ranks' int8 contributions to ITS slice
    contrib = bq.dequantize(qt, st, torch.float32).reshape(n, -1)
    my_slice = torch.mean(contrib, dim=0)
    # gather the reduced slices back (compressed again on the wire)
    qg, sg = bq.quantize(my_slice.reshape(-1, BLOCK))
    (qall, wait_q), (sall, wait_s) = _gather(qg, group), _gather(sg, group)
    wait_q()
    wait_s()
    full = bq.dequantize(qall, sall, torch.float32).reshape(-1)
    return full[: g.numel()].reshape(g.shape).to(g.dtype), new_res


def chunked_all_gather(x: torch.Tensor, group=None, *, page_chunks: int = 4,
                       critical_rows: int = 0, compress_pages: str = "int8") -> torch.Tensor:
    """Dual-granularity gather of x (leading dim = rows) over ``group``.

    The first ``critical_rows`` rows are the sub-block class: gathered FIRST,
    uncompressed (latency path).  The remainder is split into ``page_chunks``
    compressed page-class gathers, all issued before the first is waited on,
    so they overlap with each other and with whatever the caller queues."""
    rows = x.shape[0]
    n = dist.get_world_size(group)
    critical_rows = min(critical_rows, rows)
    parts = []  # (gathered, part_rows)
    if critical_rows:
        parts.append((compressed_all_gather(x[:critical_rows], group, compress="none"),
                      critical_rows))
    body_rows = rows - critical_rows
    if body_rows:
        page_chunks = max(1, min(page_chunks, body_rows))
        bounds = [critical_rows + (body_rows * i) // page_chunks for i in range(page_chunks + 1)]
        pending = [(_start_gather(x[lo:hi], group, compress_pages), hi - lo)
                   for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
        parts += [(finish(), r) for finish, r in pending]
    # each part is (n * part_rows, ...) shard-tiled; re-interleave to (n*rows, ...)
    stacked = torch.cat([p.reshape(n, r, *x.shape[1:]) for p, r in parts], dim=1)
    return stacked.reshape(n * rows, *x.shape[1:])
