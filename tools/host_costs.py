#!/usr/bin/env python3
"""The host-side costs around the DaeMon collectives and a checkpoint's
snapshot, on one CUDA card.

    python3 tools/host_costs.py

Prints two JSON lines:
  * gathers: ``chunked_all_gather`` of h2o-danube-1.8b's largest stacked
    weight (``w_gate``, 24 x 2560 x 6912 f32) with 1 critical layer and 1, 2,
    4, 8 and 16 page chunks (and 8 with none critical), beside the one-piece
    ``compressed_all_gather``: CUDA-event median, the host clock to return
    (issue) and the host clock to a synchronise; then 100 NCCL all-gathers
    of 4 KB, synchronous and with ``async_op=True`` + ``wait()``, to give the
    host cost of one NCCL call.  World size 1 (one card: NCCL copies locally).
  * copies: one 1.7 GB f32 tensor (``w_gate``'s size) to host memory, as the
    checkpoint's snapshot copies it (``.to("cpu")``: fresh pageable memory),
    into pageable memory already touched, and into pinned memory
    (``non_blocking``), with the time to allocate the pinned buffer.
Needs the card and the rest of the repository beside it.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

W_GATE = (24, 2560, 6912)


def host_ms(torch, fn, reps: int = 5):
    """Median over ``reps`` calls of (host ms to return, host ms to a
    synchronise), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        runs.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    return sorted(runs, key=lambda r: r[1])[reps // 2]


def gathers(torch, time_ms):
    import torch.distributed as dist

    from repro_torch.core import movement as mv

    store = ROOT / "build" / f"host_costs_pg.{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group(backend="cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        g = torch.randn(W_GATE, device="cuda")
        fns = {"compressed_all_gather": lambda: mv.compressed_all_gather(g)}
        for chunks in (1, 2, 4, 8, 16):
            fns[f"chunked_{chunks}_pages"] = (
                lambda c=chunks: mv.chunked_all_gather(g, page_chunks=c, critical_rows=1))
        fns["chunked_8_pages_none_critical"] = (
            lambda: mv.chunked_all_gather(g, page_chunks=8, critical_rows=0))
        out = {}
        for name, fn in fns.items():
            issue, synced = host_ms(torch, fn)
            out[name] = {"event_ms": time_ms(torch, fn, 5, 1), "host_issue_ms": issue,
                         "host_synced_ms": synced}
        small = torch.zeros(1024, device="cuda")

        def calls(async_op):
            for _ in range(100):
                o = torch.empty_like(small)
                work = dist.all_gather_into_tensor(o, small, async_op=async_op)
                if work is not None:
                    work.wait()

        for async_op in (False, True):
            out[f"100_small_nccl_calls_async_{async_op}"] = {
                "host_synced_ms": host_ms(torch, lambda: calls(async_op))[1]}
        return out
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def copies(torch):
    x = torch.randn(W_GATE, device="cuda")
    gb = x.numel() * x.element_size() / 1e9
    torch.cuda.synchronize()

    def clock(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {"gb": gb}
    out["to_cpu_fresh_s"] = [clock(lambda: x.to("cpu", copy=True)) for _ in range(2)]
    touched = torch.zeros(x.shape, dtype=x.dtype)
    out["into_touched_pageable_s"] = clock(lambda: touched.copy_(x))
    holder = {}
    out["pinned_alloc_s"] = clock(
        lambda: holder.setdefault("p", torch.empty(x.shape, dtype=x.dtype, pin_memory=True)))
    out["into_pinned_s"] = [clock(lambda: holder["p"].copy_(x, non_blocking=True))
                            for _ in range(2)]
    out["gb_per_s"] = {"to_cpu_fresh": gb / min(out["to_cpu_fresh_s"]),
                       "into_touched_pageable": gb / out["into_touched_pageable_s"],
                       "into_pinned": gb / min(out["into_pinned_s"])}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("host_costs: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi, time_ms

    smi = nvidia_smi()
    print(json.dumps({"tool": "host_costs", "part": "gathers", "nvidia_smi": smi,
                      "torch": torch.__version__, **gathers(torch, time_ms)}), flush=True)
    print(json.dumps({"tool": "host_costs", "part": "copies", "nvidia_smi": smi,
                      **copies(torch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
