#!/usr/bin/env python3
"""The DaeMon collectives between data-parallel ranks, one process a card.

    python3 tools/collectives_ranks.py                      # 4 ranks, 4 cards, NCCL
    python3 tools/collectives_ranks.py --device cpu --reduced  # 4 gloo ranks, CPU

Each rank holds its own f32 gradient and residual at h2o-danube-1.8b's 11
foldable shapes (seeded by rank) and a row shard (1/n of the layers) of each
of its 7 stacked weights.  Rank 0 prints one JSON line with, summed over the
shapes, CUDA-event medians of 5 calls after 1 warm-up (a barrier before each):
  * ``compressed_grad_sync`` with compress int8 (K1/K2 around an all-to-all
    and an all-gather of codes and scales), bf16 and none (an all-reduce);
  * ``compressed_all_gather`` int8 and none, and ``chunked_all_gather`` (one
    critical layer, 8 int8 page chunks), of the weight shards;
  * the bytes each rank hands the collectives, int8 against f32.
Every rank checks that the int8 calls on its card over NCCL give the bits
that the same calls on CPU copies over gloo give through the plain K1/K2, at
the 4 fold-only shapes and the smallest weight; ``g_mean`` may differ there
by one int8 step of its block's scale, as the n contributions may be summed
in another order.  Exits 1 if a check fails or a rank does not finish.
Needs ``--ranks`` cards (or ``--device cpu``) and the rest of the repository
beside it.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ARCH, SEED, CRITICAL_ROWS, PAGE_CHUNKS = "h2o-danube-1.8b", 0, 1, 8


def _same(got, want, block_step: bool) -> float:
    """The largest difference of ``got`` (any device) from ``want`` (CPU), in
    units of the int8 step of each 128-block of ``want`` if ``block_step``,
    else 0.0 when the bits are equal and inf when they are not."""
    import torch

    got = got.cpu()
    if not block_step:
        return 0.0 if got.dtype == want.dtype and torch.equal(got, want) else math.inf
    g, w = got.reshape(-1, 128), want.reshape(-1, 128)
    step = w.abs().amax(dim=-1, keepdim=True) / 127
    return float(((g - w).abs() / step.clamp_min(1e-30)).max())


def worker(rank: int, n: int, device: str, reduced: bool, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from chip_smoke import _spec_shapes, time_ms
    from repro_torch.configs import get_config
    from repro_torch.core import movement as mv
    from repro_torch.core.movement.daemon_step import is_foldable, is_page_class
    from repro_torch.kernels.block_quant.ops import wire_bytes

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("cpu:gloo,cuda:nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank, world_size=n,
                            timeout=timedelta(seconds=300))
    try:
        cfg = get_config(ARCH)
        cfg = cfg.reduced() if reduced else cfg
        weights = _spec_shapes(cfg, is_page_class)
        fold_only = _spec_shapes(cfg, lambda s: is_foldable(s) and not is_page_class(s))
        grads = fold_only + weights
        smallest = min(weights, key=math.prod)
        gen = torch.Generator(device=dev).manual_seed(SEED + rank)

        def shard(shape):
            return (max(1, shape[0] // n),) + shape[1:]

        def timed(fn):
            dist.barrier()
            return time_ms(torch, fn, 5, 1) if cuda else _host_ms(fn)

        times = {k: 0.0 for k in ("grad_sync_int8_ms", "grad_sync_bf16_ms", "grad_sync_none_ms",
                                  "all_gather_int8_ms", "all_gather_none_ms",
                                  "chunked_all_gather_ms")}
        wire = {"grad_sync_int8": 0, "grad_sync_f32": 0, "all_gather_int8": 0,
                "all_gather_f32": 0}
        worst = {"grad_sync g_mean (int8 steps)": 0.0, "grad_sync new_residual": 0.0,
                 "all_gather": 0.0, "chunked_all_gather": 0.0}
        for shape in grads:
            g = torch.randn(shape, generator=gen, device=dev)
            r = torch.randn(shape, generator=gen, device=dev) * 1e-2
            for c in ("int8", "bf16", "none"):
                times[f"grad_sync_{c}_ms"] += timed(
                    lambda: mv.compressed_grad_sync(g, None, r, compress=c))
            numel = math.prod(shape)
            padded = -(-numel // (128 * n)) * 128 * n
            wire["grad_sync_int8"] += 2 * (n - 1) * wire_bytes((padded,)) // n
            wire["grad_sync_f32"] += 2 * (n - 1) * 4 * numel // n
            if shape in fold_only or shape == smallest:
                gm, res = mv.compressed_grad_sync(g, None, r, compress="int8")
                gm_c, res_c = mv.compressed_grad_sync(g.cpu(), None, r.cpu(), compress="int8")
                worst["grad_sync g_mean (int8 steps)"] = max(
                    worst["grad_sync g_mean (int8 steps)"], _same(gm, gm_c, True))
                worst["grad_sync new_residual"] = max(worst["grad_sync new_residual"],
                                                      _same(res, res_c, False))
            del g, r
        for shape in weights:
            w = torch.randn(shard(shape), generator=gen, device=dev)
            for c in ("int8", "none"):
                times[f"all_gather_{c}_ms"] += timed(lambda: mv.compressed_all_gather(w, compress=c))
            times["chunked_all_gather_ms"] += timed(lambda: mv.chunked_all_gather(
                w, page_chunks=PAGE_CHUNKS, critical_rows=CRITICAL_ROWS))
            numel = w.numel()
            wire["all_gather_int8"] += (n - 1) * wire_bytes((-(-numel // 128) * 128,))
            wire["all_gather_f32"] += (n - 1) * 4 * numel
            if shape == smallest:
                for name, fn in (("all_gather", lambda x: mv.compressed_all_gather(x)),
                                 ("chunked_all_gather", lambda x: mv.chunked_all_gather(
                                     x, page_chunks=PAGE_CHUNKS, critical_rows=CRITICAL_ROWS))):
                    worst[name] = max(worst[name], _same(fn(w), fn(w.cpu()), False))
            del w
        ok = (worst["grad_sync g_mean (int8 steps)"] <= 1 + 1e-6
              and all(v == 0.0 for k, v in worst.items() if not k.startswith("grad_sync g_")))
        result = {"rank": rank, "ok": ok, "worst": worst, "times": times, "wire_bytes": wire}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def _host_ms(fn) -> float:
    """On the CPU: the median host clock of 5 calls after 1."""
    fn()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true", help="reduced danube's shapes")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for every rank")
    a = ap.parse_args()

    import torch

    if a.device == "cuda" and torch.cuda.device_count() < a.ranks:
        print(f"collectives_ranks: {torch.cuda.device_count()} cards, not {a.ranks}",
              file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / f"collectives_ranks.{os.getpid()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, a.ranks, a.device, a.reduced, str(store),
                                              str(out_dir)))
             for r in range(a.ranks)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + a.timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    results = [json.loads((out_dir / f"rank{r}.json").read_text())
               for r in range(a.ranks) if (out_dir / f"rank{r}.json").exists()]
    line = {"tool": "collectives_ranks", "device": a.device, "ranks": a.ranks,
            "reduced": a.reduced, "exit_codes": codes, "wall_s": time.perf_counter() - t0,
            "checks_ok": [r["ok"] for r in results],
            "worst": {k: max(r["worst"][k] for r in results) for k in results[0]["worst"]}
            if results else None,
            "rank0": results[0] if results else None}
    if a.device == "cuda":
        from chip_smoke import nvidia_smi

        line["nvidia_smi"] = nvidia_smi()
    print(json.dumps(line), flush=True)
    return 0 if codes == [0] * a.ranks and len(results) == a.ranks and all(
        r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
