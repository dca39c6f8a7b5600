#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card (written for an H100) and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero before the last line:
  1. env      the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
  2. build    every kernel of the serving paths from the sources in the
              checkout, one nvcc per source, all started together;
  3. kernels  each kernel against its plain PyTorch version on the card, at the
              serving paths' shapes, the parity-test shapes and ragged shapes,
              timed with CUDA events beside its bound and the plain version's
              time (K1/K2 block_quant, K3 flash_attention in f32 and bf16,
              with the HGMMA count of its tensor-core kernels' SASS and
              scaled_dot_product_attention's time beside it, K4 mamba_scan
              with no spills and its shares of the bound and of the SFU's
              exp floor);
  4. serve    serve("h2o-danube-1.8b", reduced=False, batch=2, prompt_len=8192,
              gen_tokens=16): the flash kernel must launch once per layer;
  5. int8     the page-class int8 working copy of the same master (K1 and K2
              once per stacked weight), then prefill + 4 greedy decode steps
              from it, against the bf16 copy run under torch.profiler (device
              busy share and time by kernel, prefill and decode);
  6. serve_ssm serve("falcon-mamba-7b", reduced=False, batch=2, prompt_len=8192,
              gen_tokens=16): the scan kernel must launch once per layer;
  7. profile_ssm a second falcon prefill and 4 decode steps under
              torch.profiler: K4's and the GEMMs' share of prefill device
              time, and decode's idle share;
  8. train_step the DaeMon training step of h2o-danube-1.8b at full width and
              depth, batch 2 x 4096 from the token pipeline, under
              DAEMON_AGGRESSIVE: 4 timed steps and one profiled step; K1 and
              K2 must launch 18 times a step (11 folded gradients, 7 working-
              copy weights), K3 and K4 never; falling losses, a live residual,
              and a working copy equal to the plain int8 round trip;
  9. collectives  the DaeMon collectives on one process group of world size 1
              (NCCL for CUDA tensors): compressed_grad_sync of f32 gradients
              with residuals at danube's 11 foldable shapes, compressed and
              chunked all-gathers of its 7 stacked weights; K1/K2 must launch
              inside them, and the results must equal the same calls on CPU
              copies (gloo, plain versions) bit for bit; timed, with the wire
              bytes int8 against f32;
 10. checkpoint  save_async's host snapshot of full-width danube's (params,
              DaemonState), timed; reduced danube's state after 2 card train
              steps serialised and restored onto the card bit for bit; save
              without zstandard raising before it writes;
 11. train    train("h2o-danube-1.8b", reduced=False, steps=3,
              global_batch=2, seq_len=4096, movement="daemon"), which runs
              DAEMON_DEFAULT and so launches no kernel;
 12. autograd_guard  K3's and K4's wrappers refuse a call that autograd would
              have to differentiate (the kernels are forward-only);
 13. reference the reduced models (danube, qwen3, falcon-mamba) on the card
              against the plain path on the CPU, and 3 DAEMON_AGGRESSIVE train
              steps of reduced danube from the same state and batches;
then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Launch counts are reset to 0 just before each
main-path phase (4-9, 11) and read just after; launches made to compare a
kernel with its plain version are not counted.  Needs one card; without CUDA, or
without the rest of the repository beside it, it fails.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores
# exp's floor, reported beside the bound: 132 SMs, 16 SFU results a clock
# each (NVIDIA's CUDA documentation, arithmetic throughput at compute
# capability 9.0), 1.98 GHz
SMS, SFU_EXP_PER_CLOCK, MAX_SM_CLOCK_HZ = 132, 16, 1.98e9

ARCH = "h2o-danube-1.8b"
SSM_ARCH = "falcon-mamba-7b"
BATCH, PROMPT, GEN = 2, 8192, 16
TRAIN_SEQ = 4096  # batch 2 x 4096: 8192 tokens a step, as the serving prompt
TRAIN_STEPS = 4  # timed, then one more under the profiler
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's loss tolerance (card vs CPU here)
SEED = 0

# (B, Sq, Skv, H, KVH, D, causal, window): tests/test_kernels.py's five
# ATTN_CASES, the danube geometry, and ragged lengths the kernel masks itself
ATTN_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 256, 256, 2, 1, 128, True, 128),
    (1, 128, 256, 2, 2, 64, False, 0),
    (2, 128, 128, 4, 4, 32, True, 0),
    (1, 256, 256, 8, 2, 80, True, 96),
    (1, 200, 200, 8, 2, 80, True, 64),
    (1, 100, 300, 4, 2, 160, False, 0),
    (1, 300, 100, 4, 1, 16, True, 50),
]

# (B, S, D, N): tests/test_kernels.py's three scan shapes, ragged shapes the
# kernel masks itself (the Pallas kernel needs S % 128 and D % 256; D = 130
# takes the 4-byte copies), and two long ones that cross the staging ring
# many times and end on a ragged chunk
SCAN_CASES = [
    (1, 128, 256, 16),
    (2, 256, 256, 16),
    (1, 256, 512, 8),
    (1, 200, 96, 16),
    (2, 37, 130, 8),
    (1, 64, 32, 4),
    (1, 4099, 200, 8),
    (2, 1030, 520, 4),
]
# and with x in bf16, as the model passes it: one shape whose rows take the
# bf16 register path (D % 8 != 0), one long one on the 16-byte copies
SCAN_CASES_BF16 = [(2, 37, 130, 8), (1, 4099, 200, 8)]
# and with x at a storage offset of 2 elements, in f32 and in bf16: D allows
# 16-byte copies but x's pointer does not, so N = 16 takes the 4-byte copies
# and the scalar h_last store
SCAN_CASE_OFFSET_X = (2, 300, 256, 16)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over ``reps`` calls of CUDA-event time, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def band_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask keeps: the work K3 must do on these inputs."""
    total = 0
    for qpos in range(sq):
        hi = min(skv - 1, qpos) if causal else skv - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def device_profile(torch, fn, ops=()) -> dict:
    """Run ``fn`` under torch.profiler: wall time, summed kernel time, the
    device's busy share of the wall time, the kernels that took most, the
    device time of the kernels each CPU op or named range in ``ops``
    launched through PyTorch (not K1/K2's, launched through ctypes), and the
    device-side span of each named range."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU launch event carries its kernel's time too
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()

    def annotation(e):  # a named range's device-side span, not a kernel
        return getattr(e, "is_user_annotation", False) or e.key in ops

    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in averages if e.device_type == cuda and not annotation(e)),
                     key=lambda k: -k[1])
    op_ms = {e.key: e.device_time_total / 1e3 for e in averages
             if e.key in ops and e.device_type != cuda}
    span_ms = {e.key: e.self_device_time_total / 1e3 for e in averages
               if e.key in ops and e.device_type == cuda}
    busy_ms = sum(ms for _, ms, _ in kernels)

    def share(*marks):
        return sum(ms for name, ms, _ in kernels if any(m in name.lower() for m in marks))

    flash_ms, scan_ms = share("flash_forward"), share("scan_kernel")
    quant_ms = share("quantize_kernel")  # K1 and K2 (dequantize_kernel)
    matmul_ms = share("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
           "flash_kernel_ms": flash_ms, "scan_kernel_ms": scan_ms, "block_quant_ms": quant_ms,
           "matmul_ms": matmul_ms,
           "share_of_device_time": {k: ms / busy_ms if busy_ms else None for k, ms in
                                    (("flash", flash_ms), ("scan", scan_ms),
                                     ("block_quant", quant_ms), ("matmul", matmul_ms))},
           "kernel_launches": sum(n for _, _, n in kernels),
           "top_kernels": [[name[:80], ms, n] for name, ms, n in kernels[:6]]}
    if ops:
        out["device_ms_by_op"] = {name: op_ms.get(name, 0.0) for name in ops}
        out["device_span_ms_by_range"] = span_ms
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def _spec_shapes(cfg, keep):
    """The shapes of the parameters ``keep`` selects."""
    from repro_torch.models import model as M
    from repro_torch.models import nn

    return [tuple(s.shape) for s in nn.tree_leaves(M.model_specs(cfg)) if keep(tuple(s.shape))]


def _flat_shapes(cfg, keep):
    """The 2-D shapes K1/K2 see for the leaves ``keep`` selects: each tensor
    flattened to (prod of leading dims, last dim)."""
    return [(int(math.prod(s[:-1])), s[-1]) for s in _spec_shapes(cfg, keep)]


def page_class_shapes(cfg):
    """The shapes working_copy hands K1/K2 under int8: every page-class weight."""
    from repro_torch.core.movement.daemon_step import is_page_class

    return _flat_shapes(cfg, is_page_class)


def fold_only_shapes(cfg):
    """The shapes only the int8 gradient fold hands K1/K2: the foldable
    gradients that are not page class (embed, lm_head, the stacked norms)."""
    from repro_torch.core.movement.daemon_step import is_foldable, is_page_class

    return _flat_shapes(cfg, lambda s: is_foldable(s) and not is_page_class(s))


def add_times(acc: dict, prefix: str, ms: float, plain_ms: float, bound_ms: float,
              times: int = 1) -> None:
    acc[prefix + "ms"] += times * ms
    acc[prefix + "plain_ms"] += times * plain_ms
    acc[prefix + "bound_ms"] += times * bound_ms


def check_block_quant(torch, cfg):
    """K1/K2 against the plain version on the same inputs, bit for bit: both
    sides do the same IEEE f32 division, half-to-even rounding, product and
    round-to-nearest-even cast, so any difference is a kernel fault.

    The shapes are every one the main path gives them: the page-class
    weights (serving's int8 copy and the training working copy: f32 in, bf16
    out) and every foldable gradient (the fold: f32 in, f32 out), plus a
    ragged one.  ``ms``/``plain_ms``/``bound_ms`` sum the working copy's 7
    launches; ``train_step_*`` sum a training step's 18 (7 + 11 folded)."""
    from repro_torch.kernels.block_quant import kernel, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "train_step_ms": 0.0, "train_step_plain_ms": 0.0, "train_step_bound_ms": 0.0}
    k2 = dict(k1)
    slice_shapes, fold_shapes = page_class_shapes(cfg), fold_only_shapes(cfg)
    cases = [(s, dt) for s in slice_shapes for dt in (torch.float32, torch.bfloat16)]
    cases += [(s, torch.float32) for s in fold_shapes]
    cases += [((300, 256), torch.float32), ((300, 256), torch.bfloat16)]
    for shape, dt in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
        q, s = kernel.quantize(x)
        q_ref, s_ref = ref.quantize_ref(x)
        dq = (q.to(torch.int32) - q_ref.to(torch.int32)).abs()
        code_diff, code_flips = int(dq.max()), int((dq > 0).sum())
        scale_err = float((s - s_ref).abs().max())
        require(code_flips == 0, f"K1 {shape} {dt}: {code_flips} codes differ (max {code_diff})")
        require(torch.equal(s, s_ref), f"K1 {shape} {dt}: scales differ by up to {scale_err}")
        row = {"shape": list(shape), "dtype": str(dt).replace("torch.", ""),
               "k1_code_flips": code_flips, "k1_scale_err": scale_err}
        # working_copy asks K2 for bf16, the fold for f32
        for k2_dt in (torch.bfloat16, torch.float32):
            x_k2 = kernel.dequantize(q, s, k2_dt)
            expect = ref.dequantize_ref(q, s, k2_dt)
            deq_err = float((x_k2.float() - expect.float()).abs().max())
            require(torch.equal(x_k2, expect),
                    f"K2 {shape} {dt} -> {k2_dt}: differs from the plain version by {deq_err}")
            row[f"k2_err_{str(k2_dt).replace('torch.', '')}_out"] = deq_err
            k2["max_abs_err"] = max(k2["max_abs_err"], deq_err)
            del x_k2, expect
        k1["max_abs_err"] = max(k1["max_abs_err"], float(code_diff))
        if dt == torch.float32 and shape in slice_shapes + fold_shapes:
            # a training step quantizes this shape once in the fold (K2 to
            # f32) and, if it is page class, once in the working copy (K2 to
            # bf16, as serving's int8 copy does)
            copied = shape in slice_shapes
            n = x.numel()
            t1 = time_ms(torch, lambda: kernel.quantize(x))
            p1 = time_ms(torch, lambda: ref.quantize_ref(x))
            b1 = (4 * n + n + 4 * n // 128) / HBM_BYTES_PER_S * 1e3
            row.update(k1_ms=t1, k1_plain_ms=p1, k1_bound_ms=b1)
            add_times(k1, "train_step_", t1, p1, b1, times=1 + copied)
            if copied:
                add_times(k1, "", t1, p1, b1)
            for k2_dt, out_bytes in ((torch.float32, 4), (torch.bfloat16, 2))[:1 + copied]:
                t2 = time_ms(torch, lambda: kernel.dequantize(q, s, k2_dt))
                p2 = time_ms(torch, lambda: ref.dequantize_ref(q, s, k2_dt))
                b2 = (n + 4 * n // 128 + out_bytes * n) / HBM_BYTES_PER_S * 1e3
                tag = str(k2_dt).replace("torch.", "")
                row.update({f"k2_{tag}_out_ms": t2, f"k2_{tag}_out_plain_ms": p2,
                            f"k2_{tag}_out_bound_ms": b2})
                add_times(k2, "train_step_", t2, p2, b2)
                if k2_dt == torch.bfloat16:
                    add_times(k2, "", t2, p2, b2)
        emit("kernels.block_quant", **row)
        del x, q, s, q_ref, s_ref
    z = torch.zeros(8, 256, device=dev)
    qz, sz = kernel.quantize(z)
    require(int(qz.abs().sum()) == 0 and float(sz.abs().sum()) == 0, "K1: zero block")
    require(float(kernel.dequantize(qz, sz).abs().sum()) == 0, "K2: zero block")
    emit("kernels.block_quant", zero_block="ok",
         slice_tensors=[list(s) for s in slice_shapes],
         fold_only_tensors=[list(s) for s in fold_shapes])
    return k1, k2


_TEMPLATE_ARG = r"f|13__nv_bfloat16|Li\d+E"
_ARG_NAMES = {"f": "float", "13__nv_bfloat16": "bf16"}


def short_kernel_name(mangled: str) -> str:
    """flash_forward_wgmma_kernel<80> or scan_kernel<bf16, 16> for its
    mangled name (a length-prefixed name ending in _kernel, then its
    template arguments)."""
    for m in re.finditer(rf"(?=(\d+)([a-z][a-z0-9_]*_kernel)I((?:{_TEMPLATE_ARG})+)E)", mangled):
        if int(m.group(1)) == len(m.group(2)):
            break
    else:
        return mangled
    args = [_ARG_NAMES.get(a, a[2:-1]) for a in re.findall(_TEMPLATE_ARG, m.group(3))]
    return f"{m.group(2)}<{', '.join(args)}>"


def ptxas_per_kernel(log: str) -> dict:
    """Registers and spill stores of each kernel in an nvcc -Xptxas=-v log."""
    found = re.findall(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes "
                       r"spill stores.*\n.*Used (\d+) registers", log)
    return {short_kernel_name(fn): {"registers": int(regs), "spill_store_bytes": int(spill)}
            for fn, _, spill, regs in found}


def sass_counts(lib: Path, opcode: str) -> dict:
    """How many ``opcode`` instructions each kernel of a built library holds,
    from ``cuobjdump -sass`` (the toolkit's)."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def check_flash_attention(torch, cfg):
    """K3 against the plain version on the same inputs, over ATTN_CASES, the
    reduced danube's head_dim 16 and the serving shape: f32 (CUDA cores) at
    |err| <= 2e-5 + 2e-5|ref|, bf16 (tensor cores) at |err| <= 1e-5 +
    1e-2|ref|, one bf16 ulp."""
    import torch.nn.functional as F

    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import kernel, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    atol, rtol = 1e-5, 1e-2

    def qkv(b, sq, skv, h, kvh, d, dt):
        return (torch.randn(b, sq, h, d, generator=gen, device=dev).to(dt),
                torch.randn(b, skv, kvh, d, generator=gen, device=dev).to(dt),
                torch.randn(b, skv, kvh, d, generator=gen, device=dev).to(dt))

    # every bf16 instance must hold wgmma (HGMMA in SASS); the f32 ones none
    lib = runtime.library_path("flash_attention")
    hgmma = {short_kernel_name(fn): n for fn, n in sass_counts(lib, "HGMMA").items()}
    tc = {fn: n for fn, n in hgmma.items() if "wgmma" in fn}
    require(len(tc) == len(kernel.HEAD_DIMS) and all(tc.values()),
            f"K3: tensor-core instances without HGMMA: {tc}")
    emit("kernels.flash_attention", hgmma_per_kernel=hgmma,
         ptxas_per_kernel=ptxas_per_kernel(lib.with_suffix(".log").read_text()))

    worst_f32 = worst_bf16 = 0.0
    for case in ATTN_CASES + [reduced_attn_case()]:
        b, sq, skv, h, kvh, d, causal, window = case
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(b, sq, skv, h, kvh, d, dt)
            out = kernel.forward(q, k, v, causal=causal, window=window)
            expect = ref.attention_ref(q, k, v, causal=causal, window=window)
            err = (out.float() - expect.float()).abs()
            if dt == torch.float32:
                excess = float((err - 2e-5 * expect.abs()).max())
                worst_f32 = max(worst_f32, float(err.max()))
                require(excess <= 2e-5,
                        f"K3 f32 {case}: |err| exceeds 2e-5 + 2e-5|ref| by {excess}")
                tol = "atol=rtol=2e-5"
            else:
                excess = float((err - rtol * expect.float().abs()).max())
                worst_bf16 = max(worst_bf16, float(err.max()))
                require(excess <= atol, f"K3 bf16 {case}: |err| exceeds {atol} + {rtol}|ref| "
                                        f"by {excess}")
                tol = f"|err| <= {atol} + {rtol}|ref|"
            emit("kernels.flash_attention", case=list(case), dtype=str(dt).replace("torch.", ""),
                 max_abs_err=float(err.max()), excess_over_tol=excess, tol=tol)

    window = cfg.window if cfg.attn_kind == "swa" else 0
    shape = (BATCH, PROMPT, PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, True, window)
    # Random q/k/v make |o| ~ sqrt(e / keys), ~0.03 for most rows here, so an
    # absolute limit would hide a wrong KV tile or window edge.  In f32 the
    # serving shape is held as tightly as the parity cases; in bf16 both sides
    # keep p in f32 (the kernel as bf16 hi + lo) and round o once, so they may
    # differ by one bf16 ulp (<= 2^-7 |o|) and no more.
    q, k, v = qkv(*shape[:6], torch.float32)
    out = kernel.forward(q, k, v, causal=True, window=window)
    expect = ref.attention_ref(q, k, v, causal=True, window=window)
    err32 = (out - expect).abs()
    excess = float((err32 - 2e-5 * expect.abs()).max())
    require(excess <= 2e-5, f"K3 f32 at the serving shape: |err| exceeds 2e-5 + 2e-5|ref| "
                            f"by {excess}")
    emit("kernels.flash_attention", case=list(shape), dtype="float32",
         max_abs_err=float(err32.max()), mean_abs_ref=float(expect.abs().mean()),
         tol="atol=rtol=2e-5")
    worst_f32 = max(worst_f32, float(err32.max()))
    del q, k, v, out, expect, err32

    q, k, v = qkv(*shape[:6], torch.bfloat16)
    out = kernel.forward(q, k, v, causal=True, window=window)
    expect = ref.attention_ref(q, k, v, causal=True, window=window)
    diff = (out.float() - expect.float()).abs()
    err = float(diff.max())
    excess = float((diff - rtol * expect.float().abs()).max())
    rel_l1 = float(diff.sum() / expect.float().abs().sum())
    require(excess <= atol, f"K3 bf16 at the serving shape: |err| exceeds {atol} + {rtol}|ref| "
                            f"by {excess}")
    worst_bf16 = max(worst_bf16, err)
    del diff

    # yardstick only, never called by the port: one PyTorch call, same function
    qpos = torch.arange(PROMPT, device=dev)[:, None]
    kpos = torch.arange(PROMPT, device=dev)[None, :]
    band = (kpos <= qpos) & (kpos > qpos - window) if window else kpos <= qpos
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)
    lib_err = float((lib_out.transpose(1, 2).float() - expect.float()).abs().max())
    del lib_out

    # kernel and library in turns (kernel, library, library, kernel)
    def k3():
        return kernel.forward(q, k, v, causal=True, window=window)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)

    k3_a, lib_a, lib_b, k3_b = (time_ms(torch, fn) for fn in (k3, sdpa, sdpa, k3))
    ms, library_ms = min(k3_a, k3_b), min(lib_a, lib_b)
    plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=True, window=window))

    b, sq, skv, h, kvh, d = shape[:6]
    flops = 4 * d * b * h * band_pairs(sq, skv, True, window)
    n_bytes = 2 * (2 * b * sq * h * d + 2 * b * skv * kvh * d)  # q, o; k, v in bf16
    bound_ms = max(flops / BF16_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOP_PER_S > n_bytes / HBM_BYTES_PER_S else "bytes"
    require(ms < library_ms, f"K3 bf16 at the serving shape: {ms} ms, not faster than "
                             f"scaled_dot_product_attention's {library_ms} ms")
    emit("kernels.flash_attention", case=list(shape), dtype="bfloat16", max_abs_err=err,
         excess_over_tol=excess, mean_abs_ref=float(expect.float().abs().mean()),
         rel_l1_err=rel_l1, tol=f"|err| <= {atol} + {rtol}|ref|", ms=ms, ms_runs=[k3_a, k3_b],
         plain_ms=plain_ms, library_ms=library_ms, library_ms_runs=[lib_a, lib_b],
         library_max_abs_err=lib_err, flop=flops, bytes=n_bytes, bound_ms=bound_ms,
         share_of_bound=bound_ms / ms, achieved_tflop_per_s=flops / ms / 1e9)
    return {"max_abs_err": worst_bf16, "f32_max_abs_err": worst_f32, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "share_of_bound": bound_ms / ms,
            "achieved_tflop_per_s": flops / ms / 1e9,
            "hgmma_instructions": sum(tc.values()), "shape": list(shape)}


def reduced_attn_case():
    """K3's case in the reduced danube that the reference phase runs on the
    card: (B, Sq, Skv, H, KVH, D, causal, window), head_dim 16."""
    from repro_torch.configs import get_config

    r = get_config(ARCH).reduced()
    return (2, 40, 40, r.num_heads, r.num_kv_heads, r.head_dim, True, r.window)


def check_mamba_scan(torch, cfg):
    """K4 against the plain version on the same inputs, on y and h_last, at
    |err| <= 1e-4 + 1e-4|ref| (tests/test_kernels.py's atol = rtol = 1e-4).
    Both sides compute in f32; K4 takes exp as ex2.approx of dt·(A·log2 e),
    the plain version an accurate exp, and they sum in other orders.  No
    instance of K4 may spill."""
    import torch.nn.functional as F

    from repro_torch.kernels import runtime
    from repro_torch.kernels.mamba_scan import kernel, ref

    log = runtime.library_path("mamba_scan").with_suffix(".log").read_text()
    ptxas = ptxas_per_kernel(log)
    require(len(ptxas) == 2 * len(kernel.STATE_DIMS),
            f"K4: ptxas reported {sorted(ptxas)}, not one instance per x type and N")
    spilled = {k: v for k, v in ptxas.items() if v["spill_store_bytes"]}
    require(not spilled, f"K4 instances spill: {spilled}")
    emit("kernels.mamba_scan", ptxas_per_kernel=ptxas)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    atol = rtol = 1e-4

    def inputs(b, s, d, n, x_dtype, falcon_a=False):
        x = torch.randn(b, s, d, generator=gen, device=dev).to(x_dtype)
        bm = torch.randn(b, s, n, generator=gen, device=dev)
        cm = torch.randn(b, s, n, generator=gen, device=dev)
        if falcon_a:  # falcon's s4d A = -(1..N), dt over its dt_bias init range
            a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(d, n).contiguous()
            dt = torch.rand(b, s, d, generator=gen, device=dev) * (1e-1 - 1e-3) + 1e-3
        else:  # tests/test_kernels.py's distributions
            a = -torch.exp(torch.randn(d, n, generator=gen, device=dev) * 0.5)
            dt = F.softplus(torch.randn(b, s, d, generator=gen, device=dev) - 1.0)
        return dt, a, bm, cm, x

    worst = 0.0

    def check(case, args, label):
        nonlocal worst
        y, h = kernel.forward(*args)
        y_ref, h_ref = ref.selective_scan_ref(*args)
        row = {"case": list(case), "x_dtype": str(args[4].dtype).replace("torch.", ""),
               "a": label, "tol": f"|err| <= {atol} + {rtol}|ref|"}
        for name, out, expect in (("y", y, y_ref), ("h_last", h, h_ref)):
            err = (out - expect).abs()
            excess = float((err - rtol * expect.abs()).max())
            row[f"{name}_max_abs_err"] = float(err.max())
            row[f"{name}_mean_abs_ref"] = float(expect.abs().mean())
            worst = max(worst, float(err.max()))
            require(excess <= atol, f"K4 {case} {label}: {name} exceeds {atol} + {rtol}|ref| "
                                    f"by {excess}")
        emit("kernels.mamba_scan", **row)

    for case in SCAN_CASES:
        check(case, inputs(*case, torch.float32), "random")
    for case in SCAN_CASES_BF16:
        check(case, inputs(*case, torch.bfloat16), "random")
    for x_dtype in (torch.float32, torch.bfloat16):
        *rest, x = inputs(*SCAN_CASE_OFFSET_X, x_dtype)
        x_off = torch.empty(x.numel() + 2, dtype=x_dtype, device=dev)[2:].view(x.shape)
        x_off.copy_(x)
        require(x_off.data_ptr() % 16 != 0 and x_off.is_contiguous(), "K4: x_off is not offset")
        check(SCAN_CASE_OFFSET_X, (*rest, x_off), "random, x at storage offset 2")
    shape = (BATCH, PROMPT, cfg.d_inner, cfg.ssm_state)
    args = inputs(*shape, torch.bfloat16, falcon_a=True)
    check(shape, args, "falcon s4d")
    del args
    args = inputs(*shape, torch.bfloat16)  # x in bf16, as the model passes it
    check(shape, args, "random")
    ms = time_ms(torch, lambda: kernel.forward(*args))
    plain_ms = time_ms(torch, lambda: ref.selective_scan_ref(*args), reps=3, warmup=1)

    b, s, d, n = shape
    updates = b * s * d * n
    flops = 8 * updates  # the Pallas shim's count (repro/kernels/mamba_scan/ops.py)
    # dt f32 + x bf16 + y f32 per (b, s, d); B, C f32 per (b, s, n); A; h_last
    n_bytes = (4 + 2 + 4) * b * s * d + 2 * 4 * b * s * n + 4 * d * n + 4 * b * d * n
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    sfu_ms = updates / (SMS * SFU_EXP_PER_CLOCK * MAX_SM_CLOCK_HZ) * 1e3
    emit("kernels.mamba_scan", case=list(shape), x_dtype="bfloat16", ms=ms, plain_ms=plain_ms,
         library_ms=None, updates=updates, flop=flops, bytes=n_bytes, bytes_bound_ms=bytes_ms,
         f32_ops_bound_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by,
         sfu_exp_bound_ms=sfu_ms, achieved_gb_per_s=n_bytes / ms / 1e6,
         share_of_bound=bound_ms / ms, share_of_sfu_floor=sfu_ms / ms)
    del args
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms, "shape": list(shape)}


# --------------------------------------------------------------------------
# phases 4-13: the main paths and the reference check
# --------------------------------------------------------------------------


def run_serve(torch, runtime, phase, arch, kernel):
    """serve(arch) at full width and depth; ``kernel`` (the path's kernel) must
    launch once per layer, and the tokens must lie in the vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.perf_counter()
    r = serve(arch, reduced=False, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN,
              movement="daemon", seed=SEED)
    wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    require(launches[kernel] == cfg.num_layers,
            f"{phase}: {kernel} launched {launches[kernel]} times, not {cfg.num_layers}")
    toks = r["tokens"]
    require(toks.shape == (BATCH, GEN) and ((toks >= 0) & (toks < cfg.vocab_size)).all(),
            f"{phase}: tokens of shape {toks.shape} out of [0, {cfg.vocab_size})")
    emit(phase, arch=arch, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN,
         prefill_s=r["prefill_s"], decode_s_per_token=r["decode_s_per_token"],
         tokens_per_s=r["tokens_per_s"], wall_s=wall,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    return launches


def run_ssm_profile(torch, runtime, cfg):
    """A second falcon-mamba prefill and 4 greedy decode steps from the bf16
    working copy, under torch.profiler; K4 must launch once per layer."""
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    dev = torch.device("cuda")
    master = nn.init_params(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    params = mv.working_copy(master, mv.DAEMON_DEFAULT)
    del master
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    prompt = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    out = {}

    def run_prefill():
        out["logits"], out["cache"] = prefill(params, {"tokens": prompt})

    def run_decode():
        tok = torch.argmax(out["logits"], dim=-1).to(torch.int32)
        out["steps"] = []
        for i in range(4):
            tok, lg, out["cache"] = decode(params, out["cache"], tok, PROMPT + i)
            out["steps"].append(lg)

    runtime.reset_launches()
    emit("profile_ssm", part="prefill (bf16 copy)", **device_profile(torch, run_prefill))
    emit("profile_ssm", part="4 decode steps (bf16 copy)", **device_profile(torch, run_decode))
    launches = dict(runtime.LAUNCHES)
    require(launches["mamba_scan.forward"] == cfg.num_layers,
            f"profile_ssm: K4 launched {launches['mamba_scan.forward']} times, "
            f"not {cfg.num_layers}")
    require(all(bool(torch.isfinite(lg).all()) for lg in [out["logits"], *out["steps"]]),
            "profile_ssm: non-finite logits")
    state = out["cache"]["state"]
    require(state.dtype == torch.float32 and bool(torch.isfinite(state).all()),
            "profile_ssm: the SSM state is not finite f32")
    emit("profile_ssm", launches=launches, logit_scale=float(out["logits"].abs().max()),
         state_shape=list(state.shape))
    del params, out
    torch.cuda.empty_cache()
    return launches


def run_int8_copy(torch, runtime, cfg):
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.models import nn

    dev = torch.device("cuda")
    master = nn.init_params(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                             dtype=torch.int32, device=dev)

    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    runtime.reset_launches()
    t0 = time.perf_counter()
    params = mv.working_copy(master, mv.DAEMON_AGGRESSIVE)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    logits, cache = prefill(params, {"tokens": prompt})
    cache = _grow_cache(cfg, cache, PROMPT + 4)
    step_logits, toks = [logits], [torch.argmax(logits, dim=-1).to(torch.int32)]
    for i in range(4):
        tok, lg, cache = decode(params, cache, toks[-1], PROMPT + i)
        step_logits.append(lg)
        toks.append(tok)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    require(launches["block_quant.quantize"] == 7 and launches["block_quant.dequantize"] == 7,
            f"int8 working copy: K1/K2 launched {launches['block_quant.quantize']}/"
            f"{launches['block_quant.dequantize']} times, not 7/7")
    require(launches["flash_attention.forward"] == 24, "int8 copy prefill: K3 not launched 24 times")
    require(all(bool(torch.isfinite(lg).all()) for lg in step_logits), "int8 copy: non-finite logits")
    del params, cache

    # the bf16 copy (serve's), fed the same tokens, for comparison (not
    # counted), under the profiler: where the device time goes, and how much
    # of the wall time the device is busy (profiled, so slower than phase 4)
    params = mv.working_copy(master, mv.DAEMON_DEFAULT)
    del master
    out = {}

    def run_prefill():
        out["logits"], out["cache"] = prefill(params, {"tokens": prompt})

    def run_decode():
        out["cache"] = _grow_cache(cfg, out["cache"], PROMPT + 4)
        out["steps"] = []
        for i in range(4):
            _, lg, out["cache"] = decode(params, out["cache"], toks[i], PROMPT + i)
            out["steps"].append(lg)

    emit("profile", part="prefill (bf16 copy)", **device_profile(torch, run_prefill))
    emit("profile", part="4 decode steps (bf16 copy)", **device_profile(torch, run_decode))
    ref_logits, cache = out["logits"], out["cache"]
    diffs = [float((ref_logits - step_logits[0]).abs().max())]
    diffs += [float((lg - step_logits[i + 1]).abs().max()) for i, lg in enumerate(out["steps"])]
    agree = float((torch.argmax(ref_logits, -1) == toks[0]).float().mean())
    emit("int8_copy", working_copy_s=copy_s, launches=launches,
         max_logit_diff_vs_bf16_copy=max(diffs), per_step_max_logit_diff=diffs,
         logit_scale=float(ref_logits.abs().max()), prefill_argmax_agreement=agree)
    del params, cache
    torch.cuda.empty_cache()
    return launches


def train_flop(cfg, batch: int, seq: int) -> dict:
    """Model FLOP of one training step, written out: 6 N per token for the
    weights (forward 2, backward 4; N every parameter, as 6·N·tokens counts
    it) plus attention's QK^T and PV products, 4·B·H·dh per (q, k) pair the
    mask keeps, three times over (forward and backward), per layer.  The
    recompute of a rematerialised layer is not model FLOP."""
    from repro_torch.models import model as M

    n = M.param_count(cfg)
    window = cfg.window if cfg.attn_kind == "swa" else 0
    pairs = band_pairs(seq, seq, True, window)
    weights = 6 * n * batch * seq
    attention = 3 * 4 * batch * cfg.num_heads * cfg.head_dim * pairs * cfg.num_layers
    return {"params": n, "weights_flop": weights, "attention_flop": attention,
            "attention_pairs_per_row_batch": pairs, "model_flop": weights + attention}


def free_memory(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def run_train_step(torch, runtime, cfg):
    """The DaeMon training step at full width: make_train_step(cfg,
    movement="daemon", movement_cfg=DAEMON_AGGRESSIVE), batch 2 x 4096 from
    the port's TokenPipeline (seed 0), 4 timed steps then one profiled.

    The hashed tokens are random and each step's batch is new, so at vocab
    32000 two effective updates (step 1's lr is 0) move a new batch's loss
    by less than the batch-to-batch spread (~0.02).  That training lowers
    the loss is held where it shows: the first batch, whose gradient entered
    every update through AdamW's first moment, is taken again under the
    final working copy.  Its numbers are printed before any check fails."""
    from repro_torch.core import movement as mv
    from repro_torch.core.movement.daemon_step import is_foldable, is_page_class
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.block_quant import ref as bq_ref
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    dev = torch.device("cuda")
    batch_size = BATCH
    master = nn.init_params(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    state = mv.init_state(master)
    params = mv.working_copy(master, mv.DAEMON_AGGRESSIVE)
    del master
    step = steps.make_train_step(cfg, total_steps=TRAIN_STEPS, movement="daemon",
                                 movement_cfg=mv.DAEMON_AGGRESSIVE)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=batch_size, seed=SEED))
    folded = sum(is_foldable(tuple(p.shape)) for p in nn.tree_leaves(params))
    copied = sum(is_page_class(tuple(p.shape)) for p in nn.tree_leaves(params))
    want = {"block_quant.quantize": folded + copied, "block_quant.dequantize": folded + copied,
            "flash_attention.forward": 0, "mamba_scan.forward": 0}
    require(folded + copied == 18, f"train_step: {folded} folded + {copied} copied tensors, not 18")

    losses, times, per_step, batches = [], [], [], []

    def one_step():
        nonlocal params, state
        batches.append({k: torch.as_tensor(v, device=dev) for k, v in next(pipe).items()})
        params, state, metrics = step(params, state, batches[-1])
        return metrics

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_STEPS):
            runtime.reset_launches()
            t0 = time.perf_counter()
            metrics = one_step()
            losses.append(float(metrics["loss"]))  # waits for the step
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step.append(dict(runtime.LAUNCHES))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        runtime.reset_launches()
        prof = device_profile(torch, lambda: losses.append(float(one_step()["loss"])),
                              ops=("aten::mm", "aten::bmm", "aten::_softmax",
                                   "aten::_softmax_backward_data", "daemon_step.grads",
                                   "daemon_step.fold", "daemon_step.adamw",
                                   "daemon_step.working_copy"))
        per_step.append(dict(runtime.LAUNCHES))
    finally:
        pipe.close()
    with torch.no_grad():  # the first batch again, through the same training forward
        first_again = float(M.loss_fn(cfg, params, batches[0])[0])
    residual = sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual))

    tokens = batch_size * TRAIN_SEQ
    step_s = statistics.median(times[1:])
    flop = train_flop(cfg, batch_size, TRAIN_SEQ)
    ops, spans = prof.pop("device_ms_by_op"), prof.pop("device_span_ms_by_range")
    breakdown = {
        "device_busy_ms": prof["device_busy_ms"],
        "weight_and_head_gemms_ms (aten::mm)": ops["aten::mm"],
        "attention_products_ms (aten::bmm: forward, recompute, backward)": ops["aten::bmm"],
        "attention_softmax_ms (forward, recompute, backward)":
            ops["aten::_softmax"] + ops["aten::_softmax_backward_data"],
        "block_quant_ms (K1 + K2)": prof["block_quant_ms"],
        "fold_aten_ms (the fold's PyTorch ops; K1/K2 apart)": ops["daemon_step.fold"],
        "adamw_ms": ops["daemon_step.adamw"],
        "working_copy_aten_ms (K1/K2 apart)": ops["daemon_step.working_copy"],
        "device_span_ms (first to last kernel of each range on the device; grads: the "
        "forward and loss, the backward runs on autograd's thread)": spans,
        "host_idle_share": prof["device_idle_share"],
    }
    emit("train_step", arch=cfg.name, batch=batch_size, seq_len=TRAIN_SEQ,
         tokens_per_step=tokens, movement="daemon (DAEMON_AGGRESSIVE)", steps=TRAIN_STEPS,
         losses=losses, first_batch_loss_after_training=first_again,
         last_below_first=losses[TRAIN_STEPS - 1] < losses[0],
         step_s_each=times, step_s=step_s, tokens_per_s=tokens / step_s,
         peak_memory_gb=peak_gb, **flop,
         train_mfu=flop["model_flop"] / step_s / BF16_FLOP_PER_S,
         mfu_peak="989 TFLOP/s bf16 (H100 SXM data sheet)",
         residual_abs_sum=residual, launches_per_step=per_step,
         nvidia_smi=nvidia_smi())
    emit("train_step", part="one profiled step (the profiler slows the host)",
         breakdown=breakdown, **prof)

    for i, launches in enumerate(per_step):
        require(launches == want, f"train_step {i}: launches {launches}, not {want}")
    require(all(math.isfinite(x) for x in losses + [first_again]),
            f"train_step: non-finite losses {losses}, {first_again}")
    require(first_again < losses[0], f"train_step: training did not lower the first batch's "
                                     f"loss: {losses[0]} -> {first_again}")
    require(residual > 0, "train_step: the error-feedback residual is zero")
    # the working copy is the plain version of the master's: the int8 round
    # trip of each page-class weight, a bf16 cast of the rest, bit for bit
    with torch.no_grad():
        for w, m in zip(nn.tree_leaves(params), nn.tree_leaves(state.master)):
            if is_page_class(tuple(m.shape)):
                expect = bq_ref.dequantize_ref(*bq_ref.quantize_ref(m), torch.bfloat16)
            else:
                expect = m.to(torch.bfloat16)
            require(torch.equal(w, expect),
                    f"train_step: a working-copy leaf of shape {tuple(m.shape)} differs "
                    "from the plain version of the master's")
            del expect
    emit("train_step", working_copy="page-class leaves == dequantize_ref(quantize_ref(master)), "
                                    "others == master.to(bf16), bit for bit: ok")
    check_fold(torch, cfg, params, state.residual, batches[-1])
    total = {k: sum(launches[k] for launches in per_step) for k in runtime.LAUNCHES}
    del params, state, batches
    free_memory(torch)
    return total


def check_fold(torch, cfg, params, residual, batch):
    """The int8 fold at full width on real gradients: one more step's grads
    under the final working copy and the live residual go through
    ``daemon_step.fold`` (K1/K2 on every foldable leaf) and through its plain
    version; the gradient that arrives and the new residual must be equal bit
    for bit.  Its launches are a comparison's, not the main path's."""
    from repro_torch.core.movement.daemon_step import fold, is_foldable
    from repro_torch.kernels.block_quant import ref as bq_ref
    from repro_torch.launch import steps
    from repro_torch.models import nn

    grads, _ = steps._value_and_grad(cfg, params, batch)
    folded, worst = 0, {"arrived": 0.0, "residual": 0.0}
    with torch.no_grad():
        for g, r in zip(nn.tree_leaves(grads), nn.tree_leaves(residual)):
            if not is_foldable(tuple(g.shape)):
                continue
            g32 = g.to(torch.float32) + r
            expect = bq_ref.dequantize_ref(*bq_ref.quantize_ref(g32), torch.float32)
            r_k = r.clone()
            arrived = fold(g, r_k)
            for key, got, want in (("arrived", arrived, expect), ("residual", r_k, g32 - expect)):
                err = float((got - want).abs().max())
                worst[key] = max(worst[key], err)
                require(torch.equal(got, want), f"train_step fold {tuple(g.shape)}: the {key} "
                                                f"gradient differs from the plain fold by {err}")
            folded += 1
            del g32, expect, r_k, arrived
    del grads
    require(folded == 11, f"train_step fold: {folded} foldable gradients, not 11")
    emit("train_step", fold_check=f"{folded} folded gradients at full width == the plain fold "
                                  "(dequantize_ref(quantize_ref(g + r)), g + r - that), "
                                  "bit for bit: ok", max_abs_err=worst)


def run_collectives(torch, runtime, cfg):
    """The DaeMon collectives at danube's full-width shapes, on one process
    group of world size 1 (gloo for CPU tensors, NCCL for CUDA ones): one
    card holds one NCCL rank, so parity between ranks is the CPU tests' and
    this phase shows K1/K2 working inside the collectives.  The main path:
    ``compressed_grad_sync`` (int8, error feedback) of f32 gradients with
    residuals at the 11 foldable shapes, and ``compressed_all_gather`` and
    ``chunked_all_gather`` (the first layer critical, DAEMON_AGGRESSIVE's
    page chunks) of the 7 stacked weights.  Then the same calls on CPU copies
    on gloo, through the plain versions, must give the same bits at the 4
    fold-only shapes and the smallest stacked weight; then each call is
    timed.  At world size 1 nothing crosses a link: the wire bytes printed
    are what the collectives hand NCCL, int8 against the f32 they replace."""
    import torch.distributed as dist

    from repro_torch.core import movement as mv
    from repro_torch.core.movement.daemon_step import is_foldable, is_page_class
    from repro_torch.kernels.block_quant.ops import wire_bytes

    dev = torch.device("cuda")
    weights = _spec_shapes(cfg, is_page_class)
    fold_only = _spec_shapes(cfg, lambda s: is_foldable(s) and not is_page_class(s))
    grads = fold_only + weights
    require(len(grads) == 11 and len(weights) == 7,
            f"collectives: {len(grads)} foldable and {len(weights)} stacked shapes, not 11 and 7")
    smallest = min(weights, key=math.prod)
    compared = set(fold_only + [smallest])
    crit, chunks = 1, mv.DAEMON_AGGRESSIVE.page_chunks
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(shape):
        g = torch.randn(shape, generator=gen, device=dev)
        return g, torch.randn(shape, generator=gen, device=dev) * 1e-2

    def calls(shape, g, r):
        out = {"grad_sync": mv.compressed_grad_sync(g, None, r, compress="int8")}
        if shape in weights:
            out["all_gather"] = (mv.compressed_all_gather(g, compress="int8"),)
            out["chunked_all_gather"] = (mv.chunked_all_gather(
                g, page_chunks=chunks, critical_rows=crit, compress_pages="int8"),)
        return out

    store = ROOT / "build" / f"chip_smoke_pg.{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group(backend="cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        torch.cuda.synchronize()
        runtime.reset_launches()
        kept = {}
        for shape in grads:
            g, r = inputs(shape)
            out = calls(shape, g, r)
            if shape in compared:
                kept[shape] = (g, r, out)
            del g, r, out
        torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
        # K1 twice and K2 three times a grad sync; once each per gather
        # and per page chunk
        want_k1 = 2 * len(grads) + sum(1 + min(chunks, s[0] - crit) for s in weights)
        want_k2 = 3 * len(grads) + sum(1 + min(chunks, s[0] - crit) for s in weights)
        emit("collectives", backend=dist.get_backend(), world_size=dist.get_world_size(),
             grad_shapes=[list(s) for s in grads], weight_shapes=[list(s) for s in weights],
             critical_rows=crit, page_chunks=chunks, launches=launches,
             expected={"block_quant.quantize": want_k1, "block_quant.dequantize": want_k2})
        require(launches["block_quant.quantize"] == want_k1
                and launches["block_quant.dequantize"] == want_k2,
                f"collectives: K1/K2 launched {launches['block_quant.quantize']}/"
                f"{launches['block_quant.dequantize']} times, not {want_k1}/{want_k2}")

        # the same calls on CPU copies, on gloo, through the plain versions
        for shape, (g, r, out) in kept.items():
            cpu = calls(shape, g.cpu(), r.cpu())
            for name, results in out.items():
                for got, want in zip(results, cpu[name]):
                    got = got.cpu()
                    err = float((got - want).abs().max()) if got.numel() else 0.0
                    require(got.dtype == want.dtype and torch.equal(got, want),
                            f"collectives {name} {shape}: card (NCCL, K1/K2) and CPU (gloo, "
                            f"plain) differ by {err}")
            del cpu
        emit("collectives", parity=f"{sorted(list(s) for s in compared)}: grad_sync (g_mean, "
                                   "new_residual), all_gather, chunked_all_gather on the card "
                                   "== on CPU copies through gloo and the plain K1/K2, bit for "
                                   "bit: ok")
        del kept

        times = {"grad_sync_ms": 0.0, "all_gather_ms": 0.0, "chunked_all_gather_ms": 0.0}
        wire = {"grad_sync_int8": 0, "grad_sync_f32": 0, "all_gather_int8": 0,
                "all_gather_f32": 0}
        n = dist.get_world_size()
        for shape in grads:
            g, r = inputs(shape)
            numel, padded = math.prod(shape), -(-math.prod(shape) // (128 * n)) * 128 * n
            times["grad_sync_ms"] += time_ms(
                torch, lambda: mv.compressed_grad_sync(g, None, r, compress="int8"), 5, 1)
            # an all-to-all and an all-gather of the int8 codes and scales,
            # against the same two collectives (an all-reduce) in f32
            wire["grad_sync_int8"] += 2 * wire_bytes((padded,))
            wire["grad_sync_f32"] += 2 * 4 * numel
            if shape in weights:
                times["all_gather_ms"] += time_ms(
                    torch, lambda: mv.compressed_all_gather(g, compress="int8"), 5, 1)
                times["chunked_all_gather_ms"] += time_ms(
                    torch, lambda: mv.chunked_all_gather(g, page_chunks=chunks, critical_rows=crit,
                                                         compress_pages="int8"), 5, 1)
                wire["all_gather_int8"] += wire_bytes((-(-numel // 128) * 128,))
                wire["all_gather_f32"] += 4 * numel
            del g, r
        # where a chunked gather's time goes: 2 NCCL calls a page chunk
        g, _ = inputs(max(weights, key=math.prod))
        emit("collectives", part=f"one chunked_all_gather of {list(g.shape)} under the profiler",
             **device_profile(torch, lambda: mv.chunked_all_gather(
                 g, page_chunks=chunks, critical_rows=crit)))
        del g
        elements = sum(math.prod(s) for s in grads)
        emit("collectives", **times, grad_sync_elements=elements,
             all_gather_elements=sum(math.prod(s) for s in weights), wire_bytes=wire,
             grad_sync_f32_over_int8=wire["grad_sync_f32"] / wire["grad_sync_int8"],
             all_gather_f32_over_int8=wire["all_gather_f32"] / wire["all_gather_int8"],
             note="CUDA-event medians of 5 after 1 warm-up, summed over the shapes; "
                  "grad_sync over the 11 foldable gradients, the gathers over the 7 "
                  "stacked weights; world size 1, so NCCL copies and nothing crosses a link",
             nvidia_smi=nvidia_smi())
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    free_memory(torch)
    return launches


def _host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure("no MemAvailable in /proc/meminfo")


def run_checkpoint(torch, cfg):
    """Checkpointing on the card: the stall ``save_async`` puts on the
    training loop (its host snapshot of full-width danube's (params,
    DaemonState)); reduced danube's state after 2 card train steps through
    the uncompressed serialise/deserialise and back onto the card, bit for
    bit, bf16 included; and ``save`` without ``zstandard`` raising before it
    writes (with it, a full save and restore).  No kernel runs here."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager, ckpt
    from repro_torch.core import movement as mv
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    dev = torch.device("cuda")
    have_zstd = ckpt.zstandard is not None
    ck_dir = ROOT / "build" / f"chip_smoke_ckpt.{os.getpid()}"
    shutil.rmtree(ck_dir, ignore_errors=True)

    # 1. the host snapshot save_async takes on the caller's thread
    master = nn.init_params(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    state = mv.init_state(master)
    params = mv.working_copy(master, mv.DAEMON_DEFAULT)
    tree = (params, state)
    leaves = list(ckpt._items(tree))
    tree_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    available = _host_available_bytes()
    what = "(params, DaemonState)"
    if 1.5 * tree_bytes > available:  # keep room for the rest of the process
        tree, what = (params, state.master), "(params, master) only: the host cannot hold all"
        tree_bytes = sum(t.numel() * t.element_size() for _, t in ckpt._items(tree))
    mgr = CheckpointManager(ck_dir / "full")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save_async(1, tree, {"step": 1, "arch": cfg.name})
    snapshot_s = time.perf_counter() - t0
    try:
        mgr.wait()
        write = "written"
    except ImportError as e:
        write = f"ImportError: {e}"
    shutil.rmtree(ck_dir / "full", ignore_errors=True)
    emit("checkpoint", part="save_async's host snapshot at full width", arch=cfg.name,
         snapshotted=what, leaves=len(leaves), bytes=tree_bytes,
         host_mem_available_bytes=available, save_async_s=snapshot_s,
         host_gb_per_s=tree_bytes / snapshot_s / 1e9, zstandard_present=have_zstd,
         background_write=write)
    del master, state, params, tree, leaves
    free_memory(torch)

    # 2. reduced danube after 2 card train steps, serialised and back
    rcfg = cfg.reduced()
    master = nn.init_params(M.model_specs(rcfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    state = mv.init_state(master)
    params = mv.working_copy(master, mv.DAEMON_AGGRESSIVE)
    step = steps.make_train_step(rcfg, total_steps=2, movement="daemon",
                                 movement_cfg=mv.DAEMON_AGGRESSIVE)
    pipe = TokenPipeline(DataConfig(vocab_size=rcfg.vocab_size, seq_len=64, global_batch=2,
                                    seed=SEED))
    try:
        for i in range(2):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in pipe.batch_at(i).items()}
            params, state, _ = step(params, state, batch)
    finally:
        pipe.close()
    tree = (params, state)
    flat = ckpt.flatten(tree)
    payload = ckpt.serialize(flat)
    back = ckpt.unflatten_into(tree, ckpt.deserialize(payload),
                               {k: ckpt.dtype_name(a) for k, a in flat.items()})
    pairs = list(zip(ckpt._items(tree), ckpt._items(back)))
    for (key, a), (key_b, b) in pairs:
        require(key == key_b and b.device == a.device and b.dtype == a.dtype
                and torch.equal(a, b), f"checkpoint: {key} differs after the round trip")
    bf16 = sum(a.dtype == torch.bfloat16 for (_, a), _ in pairs)
    require(bf16 == len(nn.tree_leaves(params)) and int(state.adam.step) == 2,
            f"checkpoint: {bf16} bf16 leaves, step {int(state.adam.step)}")
    emit("checkpoint", part="reduced danube after 2 card train steps, serialised and back",
         leaves=len(pairs), bf16_leaves=bf16, payload_bytes=len(payload),
         round_trip="every leaf equal, on the card, in its dtype: ok")

    # 3. save: without zstandard it raises before writing; with it, it saves
    mgr = CheckpointManager(ck_dir / "reduced")
    if have_zstd:
        mgr.save(2, tree, {"step": 2})
        restored, extra = mgr.restore(None, tree)
        require(extra == {"step": 2} and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(ckpt._items(tree), ckpt._items(restored))),
            "checkpoint: save/restore changed the state")
        outcome = "saved and restored, bit for bit"
    else:
        try:
            mgr.save(2, tree, {"step": 2})
            outcome = None
        except ImportError as e:
            outcome = f"ImportError before writing: {e}"
        require(outcome is not None, "checkpoint: save without zstandard did not raise")
        require(not any((ck_dir / "reduced").iterdir()),
                "checkpoint: save without zstandard left files")
    shutil.rmtree(ck_dir, ignore_errors=True)
    emit("checkpoint", zstandard_present=have_zstd, save=outcome)
    del master, state, params, tree, flat, back, pairs
    free_memory(torch)


def run_train(torch, runtime):
    """The training entry point itself at full width; it runs DAEMON_DEFAULT, as
    JAX's train() does, so no kernel launches."""
    from repro_torch.launch.train import train

    runtime.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):  # its per-step lines go on this phase's line
        params, state, losses = train(ARCH, reduced=False, steps=3, global_batch=BATCH,
                                      seq_len=TRAIN_SEQ, movement="daemon", log_every=1,
                                      seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    require(len(losses) == 3 and all(math.isfinite(x) for x in losses),
            f"train: losses {losses}")
    require(not any(launches.values()), f"train: DAEMON_DEFAULT launched kernels: {launches}")
    emit("train", arch=ARCH, batch=BATCH, seq_len=TRAIN_SEQ, steps=3, losses=losses,
         wall_s=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, log=log.getvalue().splitlines(),
         note="train() runs DAEMON_DEFAULT (bf16 gradients, bf16 working copy), as JAX's "
              "does: no kernel launches; log holds its per-step lines (s/step is the mean "
              "over the steps so far, the first step's first-call set-up included)")
    del params, state
    free_memory(torch)
    return launches


def run_autograd_guard(torch):
    """K3 and K4 are forward-only, as the Pallas kernels are: their wrappers
    must refuse a CUDA call that autograd would differentiate.  Without the
    guard such a call returns an output with no grad_fn (shown here on the
    kernel itself), and the inputs would get no gradient without a word."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mamba_scan import selective_scan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(1, 128, h, 64, generator=gen, device=dev, dtype=torch.bfloat16)
               .requires_grad_() for h in (4, 2, 2))
    bare = fa_kernel.forward(q, k, v, causal=True, window=0)
    refused = {}
    for name, call in (("flash_attention", lambda: flash_attention(q, k, v)),
                       ("selective_scan", lambda: selective_scan(
                           *(torch.rand(*shape, device=dev, requires_grad=True)
                             for shape in ((1, 64, 32), (32, 4), (1, 64, 4), (1, 64, 4),
                                           (1, 64, 32)))))):
        try:
            call()
        except RuntimeError as e:
            refused[name] = str(e)
    require(set(refused) == {"flash_attention", "selective_scan"},
            f"autograd_guard: calls not refused: {sorted({'flash_attention', 'selective_scan'} - set(refused))}")
    with torch.no_grad():
        out = flash_attention(q, k, v)
    require(out.shape == q.shape, "autograd_guard: no_grad call failed")
    emit("autograd_guard", refused=refused,
         kernel_output_without_guard={"requires_grad": bare.requires_grad,
                                      "grad_fn": None if bare.grad_fn is None
                                      else type(bare.grad_fn).__name__})


def run_reference(torch):
    """The reduced model, same weights and prompt, on the card (kernels) and on
    the CPU (plain versions): prefill logits and 4 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.models import nn

    tol = 8e-2  # bf16 compute on both sides, rounded at different places
    worst = {}
    for arch in (ARCH, "qwen3-14b", SSM_ARCH):
        cfg = get_config(arch).reduced()
        master = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(SEED),
                                torch.device("cpu"))
        prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
        outs = {}
        for name in ("cpu", "cuda"):
            dev = torch.device(name)
            params = mv.working_copy(nn.tree_map(lambda t: t.to(dev), master), mv.DAEMON_DEFAULT)
            logits, cache = steps.make_prefill_step(cfg)(params, {"tokens": prompt.to(dev)})
            cache = _grow_cache(cfg, cache, 44)
            seq = [logits.cpu()]
            tok = torch.argmax(logits, -1).to(torch.int32)
            for i in range(4):
                tok, lg, cache = steps.make_decode_step(cfg)(params, cache, tok, 40 + i)
                seq.append(lg.cpu())
            outs[name] = seq
        worst[arch] = max(float((a - b).abs().max()) for a, b in zip(outs["cpu"], outs["cuda"]))
        require(worst[arch] <= tol, f"{arch} reduced: card vs CPU logits differ by {worst[arch]}")
    emit("reference", max_logit_diff_card_vs_cpu=worst, tol=tol)
    run_reference_train(torch)


def run_reference_train(torch):
    """3 DAEMON_AGGRESSIVE train steps of the reduced danube (SWA window 16 <
    seq 64) on the card (K1/K2 in the fold and the working copy, nn.attention
    in the loss) and on the CPU (plain versions), from the same state and
    batches: the losses agree within the CPU parity tests' LOSS_RTOL."""
    from repro_torch.configs import get_config
    from repro_torch.core import movement as mv
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    cfg = get_config(ARCH).reduced()
    master = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(SEED),
                            torch.device("cpu"))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2,
                                    seed=SEED))
    batches = [pipe.batch_at(i) for i in range(3)]
    pipe.close()
    losses, residual = {}, {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        # a copy each: the step updates the master in place
        state = mv.init_state(nn.tree_map(lambda t: t.to(dev, copy=True), master))
        params = mv.working_copy(state.master, mv.DAEMON_AGGRESSIVE)
        step = steps.make_train_step(cfg, total_steps=3, movement="daemon",
                                     movement_cfg=mv.DAEMON_AGGRESSIVE)
        losses[name] = []
        for b in batches:
            params, state, m = step(params, state,
                                    {k: torch.as_tensor(v, device=dev) for k, v in b.items()})
            losses[name].append(float(m["loss"]))
        residual[name] = sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    require(rel <= LOSS_RTOL, f"reduced danube training: card vs CPU losses differ by {rel} "
                              f"(relative): {losses}")
    require(residual["cuda"] > 0, "reduced danube training: the residual is zero on the card")
    emit("reference", part="3 DAEMON_AGGRESSIVE train steps, reduced danube", losses=losses,
         max_relative_loss_diff_card_vs_cpu=rel, tol=LOSS_RTOL, residual_abs_sum=residual)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    nvcc = subprocess.run([runtime.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    seconds = runtime.build()
    ptxas = {}
    for name in runtime.SOURCES:
        log = runtime.library_path(name).with_suffix(".log").read_text()
        ptxas[name] = {
            "max_registers": max(map(int, re.findall(r"Used (\d+) registers", log))),
            "spill_store_bytes": sum(map(int, re.findall(r"(\d+) bytes spill stores", log))),
        }
    emit("build", wall_s=time.perf_counter() - t0, per_library_s=seconds, ptxas=ptxas,
         libraries=[runtime.library_path(n).name for n in runtime.SOURCES])

    cfg, ssm_cfg = get_config(ARCH), get_config(SSM_ARCH)
    k1, k2 = check_block_quant(torch, cfg)
    k3 = check_flash_attention(torch, cfg)
    torch.cuda.empty_cache()
    k4 = check_mamba_scan(torch, ssm_cfg)
    torch.cuda.empty_cache()

    per_phase = {"serve": run_serve(torch, runtime, "serve", ARCH, "flash_attention.forward")}
    torch.cuda.empty_cache()
    per_phase["int8_copy"] = run_int8_copy(torch, runtime, cfg)
    torch.cuda.empty_cache()
    per_phase["serve_ssm"] = run_serve(torch, runtime, "serve_ssm", SSM_ARCH, "mamba_scan.forward")
    torch.cuda.empty_cache()
    per_phase["profile_ssm"] = run_ssm_profile(torch, runtime, ssm_cfg)
    free_memory(torch)
    per_phase["train_step"] = run_train_step(torch, runtime, cfg)
    per_phase["collectives"] = run_collectives(torch, runtime, cfg)
    run_checkpoint(torch, cfg)
    per_phase["train"] = run_train(torch, runtime)
    run_autograd_guard(torch)
    run_reference(torch)

    src = "src/repro_torch/kernels"

    def launches(name):
        return sum(p[name] for p in per_phase.values())

    def by_phase(name):
        return {ph: p[name] for ph, p in per_phase.items()}

    kernels = [
        {"name": "block_quant.quantize (K1)", "route": "cuda",
         "source": f"{src}/block_quant/csrc/block_quant.cu",
         "replaces": "src/repro/kernels/block_quant/block_quant.py:25",
         "launches": launches("block_quant.quantize"),
         "launches_by_phase": by_phase("block_quant.quantize"),
         "max_abs_err": k1["max_abs_err"], "tol": "codes and scales equal",
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "train_step_ms": k1["train_step_ms"], "train_step_plain_ms": k1["train_step_plain_ms"],
         "train_step_bound_ms": k1["train_step_bound_ms"],
         "per": "sum over the 7 stacked danube weights, f32 in; train_step_*: over a "
                "training step's 18 launches, the 11 folded gradients and the 7 weights"},
        {"name": "block_quant.dequantize (K2)", "route": "cuda",
         "source": f"{src}/block_quant/csrc/block_quant.cu",
         "replaces": "src/repro/kernels/block_quant/block_quant.py:37",
         "launches": launches("block_quant.dequantize"),
         "launches_by_phase": by_phase("block_quant.dequantize"),
         "max_abs_err": k2["max_abs_err"], "tol": "bit-identical",
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "train_step_ms": k2["train_step_ms"], "train_step_plain_ms": k2["train_step_plain_ms"],
         "train_step_bound_ms": k2["train_step_bound_ms"],
         "per": "sum over the 7 stacked danube weights, bf16 out; train_step_*: over a "
                "training step's 18 launches, f32 out for the 11 folded gradients"},
        {"name": "flash_attention.forward (K3)", "route": "cuda",
         "source": f"{src}/flash_attention/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:29",
         "launches": launches("flash_attention.forward"),
         "launches_by_phase": by_phase("flash_attention.forward"),
         "max_abs_err": k3["max_abs_err"], "f32_max_abs_err": k3["f32_max_abs_err"],
         "tol": "bf16 |err| <= 1e-5 + 1e-2|ref|; f32 atol=rtol=2e-5",
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "share_of_bound": k3["share_of_bound"],
         "achieved_tflop_per_s": k3["achieved_tflop_per_s"],
         "hgmma_instructions": k3["hgmma_instructions"],
         "per": f"one launch (one layer) at {k3['shape']}, bf16 (wgmma + TMA)"},
        {"name": "mamba_scan.forward (K4)", "route": "cuda",
         "source": f"{src}/mamba_scan/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:27",
         "launches": launches("mamba_scan.forward"),
         "launches_by_phase": by_phase("mamba_scan.forward"),
         "max_abs_err": k4["max_abs_err"], "tol": "y and h_last |err| <= 1e-4 + 1e-4|ref|",
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "share_of_bound": k4["share_of_bound"],
         "per": f"one launch (one layer) at (B, S, D, N) = {k4['shape']}, x bf16"},
    ]
    for kern in kernels:
        require(kern["launches"] > 0, f"{kern['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
