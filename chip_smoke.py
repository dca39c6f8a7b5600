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
              exp floor); K3 also at whisper's three serving shapes and
              internvl2's (head_dim 128; its ptxas registers and spill
              recorded); K1/K2 also at deepseek-v2-lite's 15 page-class
              shapes at full depth, three of them 4.80e9-element expert
              stacks held on row slices across element 2^31;
  4. capture  for each Hopper launch in repro_torch.capture's catalog (K3's
              prefill and decode, K4 and K1 at the JAX catalog's shapes): the
              kernel at that shape against its plain version, the shim's
              grid, threads and CTAs an SM against the launcher's and the
              card's occupancy query, and the trace's counts (accesses,
              bytes moved by operand, footprint, compressibility, compute
              and byte time) beside the launch's CUDA-event time;
  5. serve    serve("h2o-danube-1.8b", reduced=False, batch=2, prompt_len=8192,
              gen_tokens=16): the flash kernel must launch once per layer;
  6. int8     the page-class int8 working copy of the same master (K1 and K2
              once per stacked weight), then prefill + 4 greedy decode steps
              from it, against the bf16 copy run under torch.profiler (device
              busy share and time by kernel, prefill and decode);
  7. serve_ssm serve("falcon-mamba-7b", reduced=False, batch=2, prompt_len=8192,
              gen_tokens=16): the scan kernel must launch once per layer;
  8. profile_ssm a second falcon prefill and 4 decode steps under
              torch.profiler: K4's and the GEMMs' share of prefill device
              time, and decode's idle share;
  9. serve_hybrid serve("zamba2-1.2b", reduced=False, batch=2, prompt_len=8192,
              gen_tokens=16): the flash kernel must launch once per
              invocation of the shared attention block (7), the scan kernel
              never;
 10. profile_hybrid a second zamba2 prefill under torch.profiler: K3's, the
              weight GEMMs', the SSD einsums' and the other (elementwise)
              kernels' shares of its device time;
 11. serve_moe serve("deepseek-v2-lite-16b", reduced=False, batch=2,
              prompt_len=8192, gen_tokens=16) at full width and depth: no
              kernel may launch (MLA's Dq 192 != Dv 128, so no K3);
 12. int8_copy_moe the streamed DAEMON_AGGRESSIVE working copy
              (init_working_copy: no f32 master beside it; K1 = K2 = 15),
              prefill and 4 greedy decode steps from it, against the bf16
              copy (logits kept on the host);
 13. profile_moe that bf16 copy's prefill and decode under torch.profiler:
              MLA attention's, the expert products', the routing and
              dispatch's and the rest's shares of prefill, decode's launches
              a token and idle share;
 14. serve_audio serve("whisper-base", reduced=False, batch=16,
              prompt_len=1500, gen_tokens=16) at full width and depth (1500
              frames, the encoder's 30-second window): the flash kernel must
              launch 18 times (encoder, decoder and cross-attention, once a
              layer each), K1/K2/K4 never;
 15. profile_audio a second whisper prefill and 4 decode steps under
              torch.profiler: device busy share, launches, device time by
              kernel and op;
 16. serve_vlm  the same serving path (serve_config) for internvl2-76b at full
              width on its first 27 of 80 layers, batch 2, 256 zero patches +
              an 8192-token prompt, 16 tokens: the flash kernel once a layer
              (head_dim 128), the peak under 75 GB;
 17. profile_vlm as 15, for that internvl2;
 18. train_step the DaeMon training step of h2o-danube-1.8b at full width and
              depth, batch 2 x 4096 from the token pipeline, under
              DAEMON_AGGRESSIVE: 4 timed steps and one profiled step; K1 and
              K2 must launch 18 times a step (11 folded gradients, 7 working-
              copy weights), K3 and K4 never; falling losses, a live residual,
              a working copy equal to the plain int8 round trip, and the fold
              of one more step's gradients equal to the plain fold;
 19. train_hybrid the same for zamba2-1.2b at full width and depth: K1 = K2 =
              20 a step (16 folded gradients, 4 working-copy weights);
 20. train_ssm  the same for falcon-mamba-7b at full width, cut to its first 8
              of 64 layers (the whole model's training state, ~131 GB, does
              not fit the card): K1 = K2 = 12 a step (9 + 3), the chunked
              scan in training, K4 never;
 21. train_moe  the same for deepseek-v2-lite-16b at full width, cut to its
              first 4 of 27 layers (the dense layer and 3 MoE layers; the
              whole model's state, ~314 GB, does not fit): K1 = K2 = 38 a
              step (23 + 15), the first batch's cross-entropy lowered;
 22. train_audio the same for whisper-base at full width and depth, batch 16
              x 1024 with zero frames: K1 = K2 = 42 a step (24 + 18);
 23. collectives  the DaeMon collectives on one process group of world size 1
              (NCCL for CUDA tensors): compressed_grad_sync of f32 gradients
              with residuals at danube's 11 foldable shapes, compressed and
              chunked all-gathers of its 7 stacked weights; K1/K2 must launch
              inside them, and the results must equal the same calls on CPU
              copies (gloo, plain versions) bit for bit; timed, with the wire
              bytes int8 against f32;
 24. checkpoint  save_async's host snapshot of full-width danube's (params,
              DaemonState), timed; reduced danube's state after 2 card train
              steps serialised and restored onto the card bit for bit; save
              without zstandard raising before it writes;
 25. train    train("h2o-danube-1.8b", reduced=False, steps=3,
              global_batch=2, seq_len=4096, movement="daemon"), which runs
              DAEMON_DEFAULT and so launches no kernel;
 26. autograd_guard  K3's and K4's wrappers refuse a call that autograd would
              have to differentiate (the kernels are forward-only);
 27. reference the reduced models (danube, qwen3, falcon-mamba, zamba2,
              deepseek, dbrx, whisper, internvl2) on the card against the
              plain path on the CPU, and 3 DAEMON_AGGRESSIVE train steps each
              of reduced danube, zamba2, falcon-mamba, deepseek, whisper and
              internvl2 from the same state and batches; the MoE routed on
              the card as on the CPU;
then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Launch counts are reset to 0 just before each
main-path phase (5-23, 25) and read just after; launches made to compare a
kernel with its plain version are not counted.  Needs one card; without CUDA, or
without the rest of the repository beside it, it fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
sys.path.insert(0, str(ROOT / "src"))

# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W), one
# source with the port's trace capture.
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_FLOP_PER_S,
    F32_FLOP_PER_S,
    HBM_BYTES_PER_S,
    SMS,
)

# exp's floor, reported beside the bound: 132 SMs, 16 SFU results a clock
# each (NVIDIA's CUDA documentation, arithmetic throughput at compute
# capability 9.0), 1.98 GHz
SFU_EXP_PER_CLOCK, MAX_SM_CLOCK_HZ = 16, 1.98e9

ARCH = "h2o-danube-1.8b"
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "zamba2-1.2b"
MOE_ARCH = "deepseek-v2-lite-16b"
SSM_TRAIN_LAYERS = 8  # falcon's training phase: its first 8 of 64 layers
# deepseek's training phase: its first 4 of 27 layers (the dense layer and 3
# MoE layers); the whole model's training state, ~314 GB, does not fit
MOE_TRAIN_LAYERS = 4
AUDIO_ARCH = "whisper-base"
VLM_ARCH = "internvl2-76b"
# whisper: B = 16 at 1500 frames, its encoder's 30-second window; the
# decoder's prompt is as long (JAX's serve ties frames to the prompt), and
# training takes 1024 (nn.attention's chunk divides it)
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_TRAIN_SEQ = 16, 1500, 1024
# internvl2-76b served on its first 27 of 80 layers: the largest depth whose
# peak stays under VLM_PEAK_GB.  The peak comes as the working copy is
# drawn, at ffn/w_down: its f32 stack and its bf16 copy beside the bf16
# embed, attention, w_gate and w_up stacks, 2.10 + 2.651 GB a layer: 73.7
# GB at 27, 76.3 at 28 (prefill's own peak is lower: the copy, the cache
# and the FFN's (2, 8448, 28672) activations)
VLM_SERVE_LAYERS = 27
VLM_PEAK_GB = 75.0
BATCH, PROMPT, GEN = 2, 8192, 16
TRAIN_SEQ = 4096  # batch 2 x 4096: 8192 tokens a step, as the serving prompt
TRAIN_STEPS = 4  # timed, then one more under the profiler
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's loss tolerance (card vs CPU here)
PROB_TOL = 2e-2  # tests/test_torch_moe.py's: the MoE router's probabilities, card vs CPU
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


def check_block_quant_moe(torch, cfg):
    """K1/K2 at deepseek-v2-lite's 15 page-class shapes at full depth, as the
    int8 working copy gives them (f32 in, bf16 out), each timed beside its
    byte bound.  The three expert stacks hold 26·64·2048·1408 = 4.80e9
    elements each, past 2^31 (19.2 GB in f32): the plain version of a whole
    one does not fit beside it, so the kernels' codes, scales and bf16
    output are held against the plain version bit for bit on row slices (the
    first rows, the rows around element 2^31, the last layer's last rows);
    the other shapes whole.  The plain version is timed whole where it fits,
    and on a stack's last layer otherwise, beside K1/K2 on the same rows."""
    from repro_torch.core.movement.daemon_step import is_page_class
    from repro_torch.kernels.block_quant import kernel, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    acc = {k: 0.0 for k in ("k1_ms", "k1_bound_ms", "k2_ms", "k2_bound_ms")}
    shapes = page_class_shapes(cfg)
    past_2_31 = 0
    for (rows, c), full in zip(shapes, _spec_shapes(cfg, is_page_class)):
        n = rows * c
        x = torch.randn((rows, c), generator=gen, device=dev).mul_(3)
        q, s = kernel.quantize(x)
        out = kernel.dequantize(q, s, torch.bfloat16)
        if n > 2 ** 31:
            r31 = 2 ** 31 // c  # the row that holds element 2^31
            spans = [(0, 2048), (r31 - 1024, r31 + 1024), (rows - 2048, rows)]
            past_2_31 += 1
        else:
            spans = [(0, rows)]
        for a, b in spans:
            q_ref, s_ref = ref.quantize_ref(x[a:b])
            require(torch.equal(q[a:b], q_ref) and torch.equal(s[a:b], s_ref),
                    f"K1 {full} rows {a}:{b}: codes or scales differ from the plain version")
            require(torch.equal(out[a:b], ref.dequantize_ref(q_ref, s_ref, torch.bfloat16)),
                    f"K2 {full} rows {a}:{b}: differs from the plain version")
            del q_ref, s_ref
        t1 = time_ms(torch, lambda: kernel.quantize(x))
        t2 = time_ms(torch, lambda: kernel.dequantize(q, s, torch.bfloat16))
        b1 = (4 * n + n + 4 * n // 128) / HBM_BYTES_PER_S * 1e3
        b2 = (n + 4 * n // 128 + 2 * n) / HBM_BYTES_PER_S * 1e3
        row = {"shape": list(full), "flat": [rows, c], "elements": n, "checked_rows": spans,
               "k1_ms": t1, "k1_bound_ms": b1, "k2_bf16_out_ms": t2, "k2_bf16_out_bound_ms": b2}
        sub = slice(None) if len(spans) == 1 else slice(rows - rows // full[0], rows)
        xs, qs, ss = x[sub], q[sub], s[sub]
        row["plain_rows"] = "all" if len(spans) == 1 else f"the last layer's {xs.shape[0]}"
        row["k1_plain_ms"] = time_ms(torch, lambda: ref.quantize_ref(xs), reps=3, warmup=1)
        row["k2_plain_ms"] = time_ms(torch, lambda: ref.dequantize_ref(qs, ss, torch.bfloat16),
                                     reps=3, warmup=1)
        if len(spans) > 1:
            row["k1_ms_same_rows"] = time_ms(torch, lambda: kernel.quantize(xs))
            row["k2_ms_same_rows"] = time_ms(torch, lambda: kernel.dequantize(qs, ss,
                                                                              torch.bfloat16))
        for key, val in (("k1_ms", t1), ("k1_bound_ms", b1), ("k2_ms", t2), ("k2_bound_ms", b2)):
            acc[key] += val
        emit("kernels.block_quant_moe", **row)
        del x, q, s, out, xs, qs, ss
        free_memory(torch)
    require(len(shapes) == 15 and past_2_31 == 3,
            f"deepseek: {len(shapes)} page-class shapes ({past_2_31} past 2^31), not 15 (3)")
    emit("kernels.block_quant_moe", arch=cfg.name, tensors=len(shapes),
         stacks_past_2_31=past_2_31, **acc,
         k1_share_of_bound=acc["k1_bound_ms"] / acc["k1_ms"],
         k2_share_of_bound=acc["k2_bound_ms"] / acc["k2_ms"],
         check="codes, scales and bf16 output == plain, bit for bit")
    return acc


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
    reduced danube's head_dim 16 and the serving shapes of danube, zamba2,
    whisper (its encoder and cross-attention non-causal, its decoder causal,
    B = 16 at 1500 frames) and internvl2 (256 patches + 8192 tokens, heads of
    128), each also timed beside its bound and one SDPA call: f32 (CUDA
    cores) at |err| <= 2e-5 + 2e-5|ref|, bf16 (tensor cores) at |err| <=
    1e-5 + 1e-2|ref|, one bf16 ulp."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
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
    ptxas = ptxas_per_kernel(lib.with_suffix(".log").read_text())
    emit("kernels.flash_attention", hgmma_per_kernel=hgmma, ptxas_per_kernel=ptxas)
    # the head dims of this path's serving shapes: whisper's 64 and
    # internvl2's 128 (whose spill is recorded, not refused: Queue 2 work)
    wgmma_ptxas = {d: ptxas[f"flash_forward_wgmma_kernel<{d}>"] for d in (64, 128)}
    emit("kernels.flash_attention", ptxas_wgmma_by_head_dim=wgmma_ptxas)

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

    # The serving shapes: danube's banded layer, where K3 must beat SDPA with
    # the band as a mask, and zamba2's full causal shared block (32/32 heads
    # of 64), once per invocation, beside SDPA's flash backend (is_causal).
    # Random q/k/v make |o| ~ sqrt(e / keys), ~0.03 for most rows here, so an
    # absolute limit would hide a wrong KV tile or window edge.  In f32 the
    # serving shapes are held as tightly as the parity cases; in bf16 both
    # sides keep p in f32 (the kernel as bf16 hi + lo) and round o once, so
    # they may differ by one bf16 ulp (<= 2^-7 |o|) and no more.
    serving = []
    for arch_cfg, must_beat_library in ((cfg, True), (get_config(HYBRID_ARCH), False)):
        window = arch_cfg.window if arch_cfg.attn_kind == "swa" else 0
        serving.append(((BATCH, PROMPT, PROMPT, arch_cfg.num_heads, arch_cfg.num_kv_heads,
                         arch_cfg.head_dim, True, window), arch_cfg.name, must_beat_library))
    # whisper's three attentions at prefill (the cross's K/V have all heads;
    # its queries are the prompt, as long as the frames) and internvl2's
    audio, vlm = get_config(AUDIO_ARCH), get_config(VLM_ARCH)
    frames = (AUDIO_BATCH, AUDIO_PROMPT, AUDIO_PROMPT, audio.num_heads)
    serving += [((*frames, audio.num_kv_heads, audio.head_dim, False, 0),
                 f"{audio.name} encoder", False),
                ((*frames, audio.num_kv_heads, audio.head_dim, True, 0),
                 f"{audio.name} decoder", False),
                ((*frames, audio.num_heads, audio.head_dim, False, 0),
                 f"{audio.name} cross", False),
                ((BATCH, vlm.num_prefix_tokens + PROMPT, vlm.num_prefix_tokens + PROMPT,
                  vlm.num_heads, vlm.num_kv_heads, vlm.head_dim, True, 0), vlm.name, False)]
    summary, others = None, []
    for shape, arch, must_beat_library in serving:
        b, sq, skv, h, kvh, d, causal, window = shape
        q, k, v = qkv(b, sq, skv, h, kvh, d, torch.float32)
        out = kernel.forward(q, k, v, causal=causal, window=window)
        expect = ref.attention_ref(q, k, v, causal=causal, window=window)
        err32 = (out - expect).abs()
        excess = float((err32 - 2e-5 * expect.abs()).max())
        require(excess <= 2e-5, f"K3 f32 at {arch}'s serving shape: |err| exceeds 2e-5 + "
                                f"2e-5|ref| by {excess}")
        emit("kernels.flash_attention", arch=arch, case=list(shape), dtype="float32",
             max_abs_err=float(err32.max()), mean_abs_ref=float(expect.abs().mean()),
             tol="atol=rtol=2e-5")
        worst_f32 = max(worst_f32, float(err32.max()))
        del q, k, v, out, expect, err32

        q, k, v = qkv(b, sq, skv, h, kvh, d, torch.bfloat16)
        out = kernel.forward(q, k, v, causal=causal, window=window)
        expect = ref.attention_ref(q, k, v, causal=causal, window=window)
        diff = (out.float() - expect.float()).abs()
        err = float(diff.max())
        excess = float((diff - rtol * expect.float().abs()).max())
        rel_l1 = float(diff.sum() / expect.float().abs().sum())
        require(excess <= atol, f"K3 bf16 at {arch}'s serving shape: |err| exceeds {atol} + "
                                f"{rtol}|ref| by {excess}")
        worst_bf16 = max(worst_bf16, err)
        del diff

        # yardstick only, never called by the port: one PyTorch call, same function
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window:
            qpos = torch.arange(sq, device=dev)[:, None]
            kpos = torch.arange(skv, device=dev)[None, :]
            lib_kw = {"attn_mask": (kpos <= qpos) & (kpos > qpos - window)}
        elif causal:
            lib_kw = {"is_causal": True}
        else:
            lib_kw = {}
        library = f"scaled_dot_product_attention({', '.join(lib_kw) or 'no mask'})"
        if kvh != h:
            lib_kw["enable_gqa"] = True

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)

        def k3():
            return kernel.forward(q, k, v, causal=causal, window=window)

        lib_err = float((sdpa().transpose(1, 2).float() - expect.float()).abs().max())
        # kernel and library in turns (kernel, library, library, kernel)
        k3_a, lib_a, lib_b, k3_b = (time_ms(torch, fn) for fn in (k3, sdpa, sdpa, k3))
        ms, library_ms = min(k3_a, k3_b), min(lib_a, lib_b)
        plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=causal,
                                                            window=window))

        flops = 4 * d * b * h * band_pairs(sq, skv, causal, window)
        n_bytes = 2 * (2 * b * sq * h * d + 2 * b * skv * kvh * d)  # q, o; k, v in bf16
        bound_ms = max(flops / BF16_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOP_PER_S > n_bytes / HBM_BYTES_PER_S else "bytes"
        emit("kernels.flash_attention", arch=arch, case=list(shape), dtype="bfloat16",
             max_abs_err=err, excess_over_tol=excess,
             mean_abs_ref=float(expect.float().abs().mean()), rel_l1_err=rel_l1,
             tol=f"|err| <= {atol} + {rtol}|ref|", ms=ms, ms_runs=[k3_a, k3_b],
             plain_ms=plain_ms, library=library,
             library_ms=library_ms, library_ms_runs=[lib_a, lib_b], library_max_abs_err=lib_err,
             flop=flops, bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
             share_of_bound=bound_ms / ms, achieved_tflop_per_s=flops / ms / 1e9)
        if must_beat_library:
            require(ms < library_ms, f"K3 bf16 at {arch}'s serving shape: {ms} ms, not faster "
                                     f"than scaled_dot_product_attention's {library_ms} ms")
        timed = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms, "share_of_bound": bound_ms / ms,
                 "achieved_tflop_per_s": flops / ms / 1e9, "shape": list(shape)}
        if summary is None:
            summary = timed
        else:
            others.append({"arch": arch, "max_abs_err": err, **timed})
        del q, k, v, qt, kt, vt, out, expect, lib_kw
        free_memory(torch)
    return {"max_abs_err": worst_bf16, "f32_max_abs_err": worst_f32,
            "hgmma_instructions": sum(tc.values()), "other_shapes": others,
            "wgmma_ptxas": wgmma_ptxas, **summary}


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
# phase 4: the Hopper launches of the trace-capture catalog
# --------------------------------------------------------------------------


def capture_case(torch, geom, cfg, gen):
    """The launch of one catalog entry on the card: (a call of the kernel at
    the entry's shape, its max |err| against the plain version on the same
    inputs, the tolerance, and the launch the launcher makes and the card's
    occupancy query gives), at the ``kernels`` phase's tolerances."""
    import torch.nn.functional as F

    from repro_torch.kernels.block_quant import kernel as bq, ref as bq_ref
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    from repro_torch.kernels.mamba_scan import kernel as ms, ref as ms_ref

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    if geom.kernel == "flash_attention":
        b, sq, skv, h, kvh, d = (cfg[k] for k in ("b", "sq", "skv", "h", "kvh", "d"))
        q, k, v = (randn(b, sq, h, d).bfloat16(), randn(b, skv, kvh, d).bfloat16(),
                   randn(b, skv, kvh, d).bfloat16())
        kw = {"causal": cfg["causal"], "window": 0}
        expect = fa_ref.attention_ref(q, k, v, **kw).float()
        diff = (fa.forward(q, k, v, **kw).float() - expect).abs()
        excess = float((diff - 1e-2 * expect.abs()).max())
        require(excess <= 1e-5, f"capture: K3 at {cfg}: |err| exceeds 1e-5 + 1e-2|ref| by {excess}")
        return (lambda: fa.forward(q, k, v, **kw), float(diff.max()), "|err| <= 1e-5 + 1e-2|ref|",
                fa.forward_bf16_launch(b, sq, h, d))
    if geom.kernel == "mamba_scan":
        b, s, d, n = (cfg[k] for k in ("b", "s", "d", "n"))
        # tests/test_kernels.py's distributions; x in bf16, as the model passes it
        x, bm, cm = randn(b, s, d).bfloat16(), randn(b, s, n), randn(b, s, n)
        a = -torch.exp(randn(d, n) * 0.5)
        dt = F.softplus(randn(b, s, d) - 1.0)
        err = 0.0
        for out, expect in zip(ms.forward(dt, a, bm, cm, x), ms_ref.selective_scan_ref(dt, a, bm, cm, x)):
            diff = (out - expect).abs()
            excess = float((diff - 1e-4 * expect.abs()).max())
            require(excess <= 1e-4, f"capture: K4 at {cfg}: |err| exceeds 1e-4 + 1e-4|ref| by {excess}")
            err = max(err, float(diff.max()))
        return (lambda: ms.forward(dt, a, bm, cm, x), err, "|err| <= 1e-4 + 1e-4|ref|",
                ms.forward_launch(b, d, n, torch.bfloat16))
    x = randn(cfg["r"], cfg["c"]) * 3
    (q, scales), (q_ref, s_ref) = bq.quantize(x), bq_ref.quantize_ref(x)
    require(torch.equal(q, q_ref) and torch.equal(scales, s_ref),
            f"capture: K1 at {cfg}: codes or scales differ from the plain version")
    return (lambda: bq.quantize(x), 0.0, "codes and scales equal",
            bq.quantize_launch(x.numel() // bq.BLOCK, x.dtype))


def run_capture(torch):
    """Each Hopper launch of ``repro_torch.capture``'s catalog: the kernel
    at the entry's shape held against its plain version, the shim's grid,
    threads and CTAs an SM held to the launcher's and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``'s, and the trace's
    counts beside the launch's CUDA-event median.  ``trace_compute_ms`` is
    the trace's gaps over the simulator's clock; ``trace_bytes_ms`` its
    moved bytes at the card's memory rate."""
    from repro_torch import capture
    from repro_torch.capture.recorder import CLOCK_HZ, PEAK_BY_UNIT

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, entry in capture.CAPTURED.items():
        res = capture.capture(name)
        geom = res.geom
        fn, err, tol, launch = capture_case(torch, geom, entry.config, gen)
        model = {"grid": tuple(geom.grid), "threads": geom.threads,
                 "ctas_per_sm": geom.ctas_per_sm}
        require(all(model[k] == launch[k] for k in model),
                f"capture {name}: the shim's launch {model} is not the card's {launch}")
        flop = geom.flops_per_step * sum(geom.steps)
        moved = sum(res.moved_bytes.values())
        emit("capture", name=name, kernel=geom.kernel, config=entry.config,
             launch={**launch, "grid": list(launch["grid"])}, ctas=geom.n_ctas,
             steps=sum(geom.steps), max_abs_err=err, tol=tol,
             n_accesses=res.n_accesses, moved_bytes=res.moved_bytes, footprint=res.footprint,
             compressibility=capture.measured_compressibility_of(name),
             trace_compute_ms=float(res.gaps.sum()) / CLOCK_HZ * 1e3,
             flop=flop, flop_ms=flop / PEAK_BY_UNIT[geom.flop_unit] * 1e3,
             trace_bytes=moved, trace_bytes_ms=moved / HBM_BYTES_PER_S * 1e3,
             ms=time_ms(torch, fn))
        free_memory(torch)


# --------------------------------------------------------------------------
# phases 5-27: the main paths and the reference check
# --------------------------------------------------------------------------


def run_serve(torch, runtime, phase, cfg, want, batch=BATCH, prompt=PROMPT, peak_gb=None):
    """serve_config(cfg) (serve(arch)'s body) with random weights; each kernel
    in ``want`` must launch as many times as it says, the tokens must lie in
    the vocabulary, and the peak stay under ``peak_gb`` if given."""
    from repro_torch.launch.serve import serve_config

    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.perf_counter()
    r = serve_config(cfg, batch=batch, prompt_len=prompt, gen_tokens=GEN, movement="daemon",
                     seed=SEED)
    wall = time.perf_counter() - t0
    launches = dict(runtime.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit(phase, arch=cfg.name, num_layers=cfg.num_layers, batch=batch, prompt_len=prompt,
         gen_tokens=GEN, prefill_s=r["prefill_s"], decode_s_per_token=r["decode_s_per_token"],
         tokens_per_s=r["tokens_per_s"], wall_s=wall, peak_memory_gb=peak, launches=launches)
    for kernel, n in want.items():
        require(launches[kernel] == n, f"{phase}: {kernel} launched {launches[kernel]} times, "
                                       f"not {n}")
    toks = r["tokens"]
    require(toks.shape == (batch, GEN) and ((toks >= 0) & (toks < cfg.vocab_size)).all(),
            f"{phase}: tokens of shape {toks.shape} out of [0, {cfg.vocab_size})")
    require(peak_gb is None or peak < peak_gb, f"{phase}: peak {peak} GB, not under {peak_gb}")
    return launches


def run_serving_profile(torch, runtime, phase, cfg, batch, prompt):
    """A second prefill and 4 greedy decode steps of ``cfg`` from the bf16
    working copy, under torch.profiler: device busy share, launches, and
    device time by kernel and by op (the weight GEMMs ``aten::mm``, the
    batched products ``aten::bmm``) for each; K3 must launch in prefill only,
    once per attention it runs (whisper: encoder, decoder and cross per
    layer), and the logits must be finite."""
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    params = mv.init_working_copy(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED),
                                  dev, mv.DAEMON_DEFAULT)
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, prompt))
    batch_in = {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device=dev)}
    batch_in.update(M.stub_inputs(cfg, batch_in["tokens"]))
    prefix = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    attentions = cfg.enc_layers + 2 * cfg.dec_layers if cfg.family == "audio" else cfg.num_layers
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    out = {}

    def run_prefill():
        out["logits"], out["cache"] = prefill(params, batch_in)

    def run_decode():
        out["cache"] = _grow_cache(cfg, out["cache"], prompt + 4)
        tok = torch.argmax(out["logits"], dim=-1).to(torch.int32)
        out["steps"] = []
        for i in range(4):
            tok, lg, out["cache"] = decode(params, out["cache"], tok, prompt + prefix + i)
            out["steps"].append(lg)

    launches = {}
    for part, fn in (("prefill", run_prefill), ("4 decode steps", run_decode)):
        runtime.reset_launches()
        prof = device_profile(torch, fn, ops=("aten::mm", "aten::bmm"))
        launches[part] = dict(runtime.LAUNCHES)
        emit(phase, arch=cfg.name, num_layers=cfg.num_layers, part=f"{part} (bf16 copy)",
             launches=launches[part], **prof)
    want = {"prefill": attentions, "4 decode steps": 0}
    for part, n in want.items():
        require(launches[part]["flash_attention.forward"] == n,
                f"{phase} {part}: K3 launched {launches[part]['flash_attention.forward']} times, "
                f"not {n}")
    require(all(bool(torch.isfinite(lg).all()) for lg in [out["logits"], *out["steps"]]),
            f"{phase}: non-finite logits")
    del params, out
    free_memory(torch)
    return {k: launches["prefill"][k] + launches["4 decode steps"][k] for k in runtime.LAUNCHES}


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


def run_hybrid_profile(torch, runtime, cfg):
    """A second zamba2 prefill from the bf16 working copy under
    torch.profiler: K3 must launch once per invocation of the shared block;
    the shares of its device time taken by K3, by the weight GEMMs
    (``aten::mm``), by the batched products (``aten::bmm``: the SSD einsums)
    and by everything else (elementwise passes, reductions, copies)."""
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.models import hybrid
    from repro_torch.models import model as M
    from repro_torch.models import nn

    dev = torch.device("cuda")
    master = nn.init_params(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    params = mv.working_copy(master, mv.DAEMON_DEFAULT)
    del master
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    prompt = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    prefill = steps.make_prefill_step(cfg)
    out = {}

    def run_prefill():
        out["logits"], out["cache"] = prefill(params, {"tokens": prompt})

    runtime.reset_launches()
    prof = device_profile(torch, run_prefill, ops=("aten::mm", "aten::bmm"))
    launches = dict(runtime.LAUNCHES)
    ninv = hybrid.n_invocations(cfg)
    require(launches["flash_attention.forward"] == ninv and launches["mamba_scan.forward"] == 0,
            f"profile_hybrid: launches {launches}, not K3 {ninv} and K4 0")
    require(bool(torch.isfinite(out["logits"]).all()), "profile_hybrid: non-finite logits")
    busy = prof["device_busy_ms"]
    mm, bmm = prof["device_ms_by_op"]["aten::mm"], prof["device_ms_by_op"]["aten::bmm"]
    flash = prof["flash_kernel_ms"]
    shares = {"flash (K3)": flash / busy, "weight_gemms (aten::mm)": mm / busy,
              "ssd_einsums (aten::bmm)": bmm / busy,
              "other (elementwise, reductions, copies)": (busy - flash - mm - bmm) / busy}
    emit("profile_hybrid", part="prefill (bf16 copy)", share_of_device_time_by_part=shares,
         launches=launches, logit_scale=float(out["logits"].abs().max()), **prof)
    del params, out
    free_memory(torch)
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
    # of the wall time the device is busy (profiled, so slower than phase 5)
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


def run_int8_copy_moe(torch, runtime, cfg):
    """deepseek-v2-lite at full width and depth from the streamed working
    copy (``init_working_copy``: no f32 master beside it): first the
    DAEMON_AGGRESSIVE copy, whose 15 page-class weights (4-D expert stacks
    among them) must go through K1 and K2 once each, then prefill and 4
    greedy decode steps from it (phase ``int8_copy_moe``); then the bf16
    copy (serve's) fed the same tokens, its prefill and decode steps under
    torch.profiler (phase ``profile_moe``: the shares of MLA's attention, the
    expert products, the routing and dispatch, and the rest; decode's
    launches a token and idle share), which no kernel may take.  The two
    copies do not fit together, so they are built one after the other and
    the logits kept on the host."""
    from repro_torch.core import movement as mv
    from repro_torch.core.movement.daemon_step import is_page_class
    from repro_torch.launch import steps
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    specs = M.model_specs(cfg)
    paged = len(_spec_shapes(cfg, is_page_class))
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                             dtype=torch.int32, device=dev)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    out = {}

    def run_prefill(params):
        logits, cache = prefill(params, {"tokens": prompt})
        out["cache"] = _grow_cache(cfg, cache, PROMPT + 4)
        out["logits"] = [logits.cpu()]

    def run_decode(params, feed):
        for i in range(4):
            _, lg, out["cache"] = decode(params, out["cache"], feed[i], PROMPT + i)
            out["logits"].append(lg.cpu())

    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    t0 = time.perf_counter()
    params = mv.init_working_copy(specs, torch.Generator(device=dev).manual_seed(SEED), dev,
                                  mv.DAEMON_AGGRESSIVE)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    copy_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run_prefill(params)
    toks = [torch.argmax(out["logits"][0], dim=-1).to(torch.int32).to(dev)]
    for i in range(4):
        tok, lg, out["cache"] = decode(params, out["cache"], toks[-1], PROMPT + i)
        out["logits"].append(lg.cpu())
        toks.append(tok)
    torch.cuda.synchronize()
    int8_logits, launches = out.pop("logits"), dict(runtime.LAUNCHES)
    want = {"block_quant.quantize": paged, "block_quant.dequantize": paged,
            "flash_attention.forward": 0, "mamba_scan.forward": 0}
    require(paged == 15 and launches == want,
            f"int8_copy_moe: launches {launches}, not {want} ({paged} page-class weights)")
    require(all(bool(torch.isfinite(lg).all()) for lg in int8_logits),
            "int8_copy_moe: non-finite logits")
    del params
    out.clear()
    free_memory(torch)

    params = mv.init_working_copy(specs, torch.Generator(device=dev).manual_seed(SEED), dev,
                                  mv.DAEMON_DEFAULT)
    runtime.reset_launches()
    ranges = ("mla.attention", "moe.experts", "moe.route", "moe.dispatch")
    parts = []
    for part, fn in (("prefill (bf16 copy)", lambda: run_prefill(params)),
                     ("4 decode steps (bf16 copy)", lambda: run_decode(params, toks))):
        prof = device_profile(torch, fn, ops=ranges)
        # a named range's CPU-side device time overcounts here (the four
        # ranges summed past the device's busy time on an H100)
        prof.pop("device_ms_by_op")
        spans, busy = prof["device_span_ms_by_range"], prof["device_busy_ms"]
        if part.startswith("prefill"):
            # device-bound (idle < 1 %), one stream: a range's device span,
            # first to last kernel, is the kernels' time
            named = {"mla_attention (its einsums, masks and softmax)": spans["mla.attention"],
                     "expert_products (three bmm and the gate)": spans["moe.experts"],
                     "routing_and_dispatch (router, top-k, cumsum, scatter, gather)":
                         spans["moe.route"] + spans["moe.dispatch"]}
            named["rest (weight GEMMs, norms, rope, head)"] = busy - sum(named.values())
            prof.update(device_ms_by_part=named,
                        share_of_device_time_by_part={k: v / busy for k, v in named.items()})
        emit("profile_moe", part=part, **prof)
        parts.append(prof)
    profile_launches = dict(runtime.LAUNCHES)
    require(not any(profile_launches.values()),
            f"profile_moe: the bf16 copy's path launched {profile_launches}")
    bf16_logits = out.pop("logits")
    require(all(bool(torch.isfinite(lg).all()) for lg in bf16_logits),
            "profile_moe: non-finite logits")
    diffs = [float((a - b).abs().max()) for a, b in zip(int8_logits, bf16_logits)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(int8_logits, bf16_logits)]
    emit("profile_moe", decode_launches_per_token=parts[1]["kernel_launches"] / 4,
         decode_idle_share=parts[1]["device_idle_share"], launches=profile_launches)
    emit("int8_copy_moe", arch=cfg.name, working_copy_s=copy_s,
         working_copy_peak_memory_gb=copy_peak_gb, page_class_weights=paged, launches=launches,
         max_logit_diff_vs_bf16_copy=max(diffs), per_step_max_logit_diff=diffs,
         greedy_agreement_per_step=agree, logit_scale=float(bf16_logits[0].abs().max()),
         note="step 0 is the prefill; both copies fed the int8 copy's greedy tokens")
    del params
    out.clear()
    free_memory(torch)
    return launches, profile_launches


def train_flop(cfg, batch: int, seq: int) -> dict:
    """Model FLOP of one training step, written out: 6 per token for each
    weight a token passes (forward 2, backward 4: every parameter but the
    routed experts a token skips, ``param_count(active_only=True)``, and the
    hybrid's shared attention+MLP block's matrices once more for each further
    invocation) plus attention's QK^T and PV products, 2·B·H·(dq + dv) per
    (q, k) pair the mask keeps (dq = dv = head_dim, but MLA's 192 and 128),
    three times over (forward and backward), per attention layer (per
    invocation of the hybrid's shared block; none in the SSM family; for the
    enc-dec, the frames as long as the tokens, every pair of the encoder's and
    the cross-attention's and the causal ones of the decoder's).  The SSM
    scans and the recompute of a rematerialised layer are not counted."""
    from repro_torch.models import hybrid
    from repro_torch.models import model as M

    n = M.param_count(cfg)
    applied, attn_layers = M.param_count(cfg, active_only=True), cfg.num_layers
    if cfg.family == "hybrid":
        shared = hybrid.shared_block_specs(cfg)
        dense = sum(math.prod(shared[k].shape) for k in ("wq", "wk", "wv", "wo", "w_gate",
                                                          "w_up", "w_down"))
        attn_layers = hybrid.n_invocations(cfg)
        applied += (attn_layers - 1) * dense
    elif cfg.family == "ssm":
        attn_layers = 0
    window = cfg.window if cfg.attn_kind == "swa" else 0
    pairs = band_pairs(seq, seq, True, window)
    dq, dv = cfg.head_dim, cfg.head_dim
    if cfg.attn_kind == "mla":
        dq, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    weights = 6 * applied * batch * seq
    layer_pairs = pairs * attn_layers
    if cfg.family == "audio":  # the encoder's and the cross-attention's pairs: all of them
        layer_pairs = cfg.enc_layers * seq * seq + cfg.dec_layers * (pairs + seq * seq)
    attention = 3 * 2 * (dq + dv) * batch * cfg.num_heads * layer_pairs
    return {"params": n, "params_applied_per_token": applied, "weights_flop": weights,
            "attention_flop": attention, "attention_pairs_per_row_batch": pairs,
            "model_flop": weights + attention}


def free_memory(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def run_train_step(torch, runtime, cfg, phase, moves, batch_size=BATCH, seq=TRAIN_SEQ):
    """The DaeMon training step at full width: make_train_step(cfg,
    movement="daemon", movement_cfg=DAEMON_AGGRESSIVE), batch 2 x 4096 (or
    ``batch_size`` x ``seq``) from the port's TokenPipeline (seed 0), with
    the stub frontend's zero frames for the enc-dec, 4 timed steps then one
    profiled.
    ``moves`` is (folded gradients, page-class weights) a step: K1 and K2
    must each launch their sum a step, K3 and K4 never.

    The hashed tokens are random and each step's batch is new, so at vocab
    32000 two effective updates (step 1's lr is 0) move a new batch's loss
    by less than the batch-to-batch spread (~0.02).  That training lowers
    the loss is held where it shows: the first batch, whose gradient entered
    every update through AdamW's first moment, is taken again under the
    final working copy; for the MoE family its cross-entropy, since its loss
    also holds 0.01 x the aux load-balance loss, which the first steps raise
    (deepseek-v2-lite on 4 layers: 12.37 -> 12.62 on an H100, its aux
    doubling, while its cross-entropy fell).  Its
    numbers are printed before any check fails."""
    from repro_torch.core import movement as mv
    from repro_torch.core.movement.daemon_step import is_foldable, is_page_class
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.block_quant import ref as bq_ref
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    dev = torch.device("cuda")
    master = nn.init_params(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    state = mv.init_state(master)
    params = mv.working_copy(master, mv.DAEMON_AGGRESSIVE)
    del master
    step = steps.make_train_step(cfg, total_steps=TRAIN_STEPS, movement="daemon",
                                 movement_cfg=mv.DAEMON_AGGRESSIVE)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch_size, seed=SEED))
    folded = sum(is_foldable(tuple(p.shape)) for p in nn.tree_leaves(params))
    copied = sum(is_page_class(tuple(p.shape)) for p in nn.tree_leaves(params))
    want = {"block_quant.quantize": folded + copied, "block_quant.dequantize": folded + copied,
            "flash_attention.forward": 0, "mamba_scan.forward": 0}
    require((folded, copied) == moves,
            f"{phase}: {folded} folded + {copied} copied tensors, not {moves[0]} + {moves[1]}")

    losses, parts, times, per_step, batches = [], [], [], [], []

    def one_step():
        nonlocal params, state
        batches.append({k: torch.as_tensor(v, device=dev) for k, v in next(pipe).items()})
        batches[-1].update(M.stub_inputs(cfg, batches[-1]["tokens"]))
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
            parts.append((float(metrics["ce"]), float(metrics["aux"])))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step.append(dict(runtime.LAUNCHES))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        runtime.reset_launches()
        prof = device_profile(torch, lambda: losses.append(float(one_step()["loss"])),
                              ops=("aten::mm", "aten::bmm", "aten::_softmax",
                                   "aten::_softmax_backward_data", "aten::mul", "aten::cat",
                                   "daemon_step.grads", "daemon_step.fold", "daemon_step.adamw",
                                   "daemon_step.working_copy"))
        per_step.append(dict(runtime.LAUNCHES))
    finally:
        pipe.close()
    with torch.no_grad():  # the first batch again, through the same training forward
        first_again, again = M.loss_fn(cfg, params, batches[0])
        first_again, first_ce_again = float(first_again), float(again["ce"])
        first_aux_again = float(again["aux"])
    residual = sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual))

    tokens = batch_size * seq
    step_s = statistics.median(times[1:])
    flop = train_flop(cfg, batch_size, seq)
    ops, spans = prof.pop("device_ms_by_op"), prof.pop("device_span_ms_by_range")
    breakdown = {
        "device_busy_ms": prof["device_busy_ms"],
        "weight_and_head_gemms_ms (aten::mm)": ops["aten::mm"],
        "batched_products_ms (aten::bmm: attention's products, the SSM bodies' einsums; "
        "forward, recompute, backward)": ops["aten::bmm"],
        "attention_softmax_ms (forward, recompute, backward)":
            ops["aten::_softmax"] + ops["aten::_softmax_backward_data"],
        "mul_ms (aten::mul: the scans' combines among them)": ops["aten::mul"],
        "cat_ms (aten::cat: the doubling scan's shifts among them)": ops["aten::cat"],
        "block_quant_ms (K1 + K2)": prof["block_quant_ms"],
        "fold_aten_ms (the fold's PyTorch ops; K1/K2 apart)": ops["daemon_step.fold"],
        "adamw_ms": ops["daemon_step.adamw"],
        "working_copy_aten_ms (K1/K2 apart)": ops["daemon_step.working_copy"],
        "device_span_ms (first to last kernel of each range on the device; grads: the "
        "forward and loss, the backward runs on autograd's thread)": spans,
        "host_idle_share": prof["device_idle_share"],
    }
    emit(phase, arch=cfg.name, num_layers=cfg.num_layers, batch=batch_size, seq_len=seq,
         tokens_per_step=tokens, movement="daemon (DAEMON_AGGRESSIVE)", steps=TRAIN_STEPS,
         losses=losses, first_batch_loss_after_training=first_again,
         ce_and_aux_timed_steps=parts,
         first_batch_ce_and_aux_after_training=[first_ce_again, first_aux_again],
         last_below_first=losses[TRAIN_STEPS - 1] < losses[0],
         step_s_each=times, step_s=step_s, tokens_per_s=tokens / step_s,
         peak_memory_gb=peak_gb, **flop,
         train_mfu=flop["model_flop"] / step_s / BF16_FLOP_PER_S,
         mfu_peak="989 TFLOP/s bf16 (H100 SXM data sheet)",
         residual_abs_sum=residual, launches_per_step=per_step,
         nvidia_smi=nvidia_smi())
    emit(phase, part="one profiled step (the profiler slows the host)",
         breakdown=breakdown, **prof)

    for i, launches in enumerate(per_step):
        require(launches == want, f"{phase} {i}: launches {launches}, not {want}")
    require(all(math.isfinite(x) for x in losses + [first_again]),
            f"{phase}: non-finite losses {losses}, {first_again}")
    if cfg.family == "moe":
        # the loss holds 0.01 x the aux load-balance loss of each MoE layer,
        # which the first Adam steps raise as the router concentrates on the
        # batches it sees; the language-model objective is the cross-entropy
        require(first_ce_again < parts[0][0], f"{phase}: training did not lower the first "
                                              f"batch's cross-entropy: {parts[0][0]} -> "
                                              f"{first_ce_again}")
    else:
        require(first_again < losses[0], f"{phase}: training did not lower the first batch's "
                                         f"loss: {losses[0]} -> {first_again}")
    require(residual > 0, f"{phase}: the error-feedback residual is zero")
    # the working copy is the plain version of the master's: the int8 round
    # trip of each page-class weight, a bf16 cast of the rest, bit for bit
    with torch.no_grad():
        for w, m in zip(nn.tree_leaves(params), nn.tree_leaves(state.master)):
            if is_page_class(tuple(m.shape)):
                expect = bq_ref.dequantize_ref(*bq_ref.quantize_ref(m), torch.bfloat16)
            else:
                expect = m.to(torch.bfloat16)
            require(torch.equal(w, expect),
                    f"{phase}: a working-copy leaf of shape {tuple(m.shape)} differs "
                    "from the plain version of the master's")
            del expect
    emit(phase, working_copy=f"{copied} page-class leaves == dequantize_ref(quantize_ref("
                             "master)), others == master.to(bf16), bit for bit: ok")
    check_fold(torch, cfg, params, state.residual, batches[-1], phase, folded)
    total = {k: sum(launches[k] for launches in per_step) for k in runtime.LAUNCHES}
    del params, state, batches
    free_memory(torch)
    return total


def check_fold(torch, cfg, params, residual, batch, phase, n_foldable):
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
                require(torch.equal(got, want), f"{phase} fold {tuple(g.shape)}: the {key} "
                                                f"gradient differs from the plain fold by {err}")
            folded += 1
            del g32, expect, r_k, arrived
    del grads
    require(folded == n_foldable, f"{phase} fold: {folded} foldable gradients, not {n_foldable}")
    emit(phase, fold_check=f"{folded} folded gradients at full width == the plain fold "
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


@contextlib.contextmanager
def moe_routes(torch, replay=None):
    """Record the experts each call of the MoE router takes (``moe.top_k``);
    or, given the record of an earlier run of the same program, make each
    call take the recorded experts, in call order, with this run's own
    probabilities at them.  The record counts the assignments where this run
    alone would have taken another expert or order, and the largest distance
    of its probabilities from the recorded run's.  Card and CPU round bf16
    differently, and a near-tie of two experts can route a token elsewhere;
    the reference phase holds the rest of the model to the CPU's on the CPU's
    routing, and the router's probabilities within PROB_TOL."""
    from repro_torch.models import moe

    real = moe.top_k
    rec = {"idx": [], "probs": [], "differs": 0, "prob_dist": 0.0}

    def top_k(probs, k):
        vals, idx = real(probs, k)
        rec["idx"].append(idx.cpu())
        rec["probs"].append(probs.detach().cpu())
        if replay is None:
            return vals, idx
        i = len(rec["idx"]) - 1
        want = replay["idx"][i].to(idx.device)
        rec["differs"] += int((idx != want).sum())
        rec["prob_dist"] = max(rec["prob_dist"],
                               float((rec["probs"][i] - replay["probs"][i]).abs().max()))
        return probs.gather(-1, want), want

    moe.top_k = top_k
    try:
        yield rec
    finally:
        moe.top_k = real


def run_reference(torch):
    """The reduced model, same weights and prompt, on the card (kernels) and on
    the CPU (plain versions): prefill logits and 4 decode steps; the MoE
    family routed on the card as on the CPU (``moe_routes``)."""
    from repro_torch.configs import get_config
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import model as M
    from repro_torch.models import nn

    tol = 8e-2  # bf16 compute on both sides, rounded at different places
    worst, routing = {}, {}
    for arch in (ARCH, "qwen3-14b", SSM_ARCH, HYBRID_ARCH, MOE_ARCH, "dbrx-132b", AUDIO_ARCH,
                 VLM_ARCH):
        cfg = get_config(arch).reduced()
        master = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(SEED),
                                torch.device("cpu"))
        # MLA attends through nn.attention at prefill, which takes a prompt
        # the attention chunk (32) divides, as JAX's does
        n = 64 if cfg.attn_kind == "mla" else 40
        prompt = torch.randint(0, cfg.vocab_size, (2, n), generator=torch.Generator().manual_seed(1))
        stub = random_stub_inputs(torch, cfg, prompt)
        prefix = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
        outs, record = {}, None
        for name in ("cpu", "cuda"):
            dev = torch.device(name)
            params = mv.working_copy(nn.tree_map(lambda t: t.to(dev), master), mv.DAEMON_DEFAULT)
            inputs = {"tokens": prompt.to(dev), **{k: t.to(dev) for k, t in stub.items()}}
            with moe_routes(torch, replay=record) as record:
                logits, cache = steps.make_prefill_step(cfg)(params, inputs)
                cache = _grow_cache(cfg, cache, n + 4)
                seq = [logits.cpu()]
                # the CPU's greedy tokens on both sides
                feed = [torch.argmax(lg, -1).to(torch.int32).to(dev) for lg in outs.get("cpu", [])]
                tok = feed[0] if feed else torch.argmax(logits, -1).to(torch.int32)
                for i in range(4):
                    nxt, lg, cache = steps.make_decode_step(cfg)(params, cache, tok,
                                                                 n + prefix + i)
                    seq.append(lg.cpu())
                    tok = feed[i + 1] if feed else nxt
            outs[name] = seq
        worst[arch] = max(float((a - b).abs().max()) for a, b in zip(outs["cpu"], outs["cuda"]))
        require(worst[arch] <= tol, f"{arch} reduced: card vs CPU logits differ by {worst[arch]}")
        if record["idx"]:
            routing[arch] = {k: record[k] for k in ("differs", "prob_dist")}
            require(record["prob_dist"] <= PROB_TOL, f"{arch} reduced: the router's "
                    f"probabilities differ by {record['prob_dist']} between card and CPU")
    emit("reference", max_logit_diff_card_vs_cpu=worst, tol=tol,
         moe_routing_card_vs_cpu=routing, prob_tol=PROB_TOL,
         note="differs: assignments the card alone would route to another expert or order")
    for arch in (ARCH, HYBRID_ARCH, SSM_ARCH, MOE_ARCH, AUDIO_ARCH, VLM_ARCH):
        run_reference_train(torch, arch)


def random_stub_inputs(torch, cfg, tokens, seed=2):
    """Like ``model.stub_inputs``, but drawn from ``seed`` on the CPU, so the
    card's encoder and patch positions see more than zeros."""
    from repro_torch.models import model as M

    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(z.shape, generator=gen).to(z.dtype)
            for k, z in M.stub_inputs(cfg, tokens).items()}


def run_reference_train(torch, arch):
    """3 DAEMON_AGGRESSIVE train steps of a reduced model (danube: SWA window
    16 < seq 64; zamba2: the shared block, Mamba2's SSD body; falcon-mamba:
    the chunked scan; whisper: encoder, cross-attention; internvl2: 4 patches
    + 60 tokens, which the attention chunk divides) on the card (K1/K2 in the fold and the working copy,
    nn.attention and the chunked scan in the loss) and on the CPU (plain
    versions), from the same state and batches: the losses agree within the
    CPU parity tests' LOSS_RTOL."""
    from repro_torch.configs import get_config
    from repro_torch.core import movement as mv
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    cfg = get_config(arch).reduced()
    master = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(SEED),
                            torch.device("cpu"))
    seq = 64 - (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=2,
                                    seed=SEED))
    batches = [{k: torch.as_tensor(v) for k, v in pipe.batch_at(i).items()} for i in range(3)]
    pipe.close()
    for i, b in enumerate(batches):
        b.update(random_stub_inputs(torch, cfg, b["tokens"], seed=10 + i))
    losses, residual, record = {}, {}, None
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        # a copy each: the step updates the master in place
        state = mv.init_state(nn.tree_map(lambda t: t.to(dev, copy=True), master))
        params = mv.working_copy(state.master, mv.DAEMON_AGGRESSIVE)
        step = steps.make_train_step(cfg, total_steps=3, movement="daemon",
                                     movement_cfg=mv.DAEMON_AGGRESSIVE)
        losses[name] = []
        with moe_routes(torch, replay=record) as record:
            for b in batches:
                params, state, m = step(params, state, {k: v.to(dev) for k, v in b.items()})
                losses[name].append(float(m["loss"]))
        residual[name] = sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    require(rel <= LOSS_RTOL, f"reduced {arch} training: card vs CPU losses differ by {rel} "
                              f"(relative): {losses}")
    require(residual["cuda"] > 0, f"reduced {arch} training: the residual is zero on the card")
    routing = {k: record[k] for k in ("differs", "prob_dist")} if record["idx"] else None
    require(routing is None or routing["prob_dist"] <= PROB_TOL,
            f"reduced {arch} training: the router's probabilities differ by {routing}")
    emit("reference", part=f"3 DAEMON_AGGRESSIVE train steps, reduced {arch}", losses=losses,
         max_relative_loss_diff_card_vs_cpu=rel, tol=LOSS_RTOL, residual_abs_sum=residual,
         moe_routing_card_vs_cpu=routing)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.models import hybrid

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

    cfg, ssm_cfg, hybrid_cfg = get_config(ARCH), get_config(SSM_ARCH), get_config(HYBRID_ARCH)
    moe_cfg, audio_cfg, vlm_cfg = get_config(MOE_ARCH), get_config(AUDIO_ARCH), get_config(VLM_ARCH)
    k1, k2 = check_block_quant(torch, cfg)
    bq_moe = check_block_quant_moe(torch, moe_cfg)
    k3 = check_flash_attention(torch, cfg)
    torch.cuda.empty_cache()
    k4 = check_mamba_scan(torch, ssm_cfg)
    torch.cuda.empty_cache()
    run_capture(torch)

    per_phase = {"serve": run_serve(torch, runtime, "serve", cfg,
                                    {"flash_attention.forward": cfg.num_layers})}
    torch.cuda.empty_cache()
    per_phase["int8_copy"] = run_int8_copy(torch, runtime, cfg)
    torch.cuda.empty_cache()
    per_phase["serve_ssm"] = run_serve(torch, runtime, "serve_ssm", ssm_cfg,
                                       {"mamba_scan.forward": ssm_cfg.num_layers})
    torch.cuda.empty_cache()
    per_phase["profile_ssm"] = run_ssm_profile(torch, runtime, ssm_cfg)
    free_memory(torch)
    ninv = hybrid.n_invocations(hybrid_cfg)
    per_phase["serve_hybrid"] = run_serve(torch, runtime, "serve_hybrid", hybrid_cfg,
                                          {"flash_attention.forward": ninv,
                                           "mamba_scan.forward": 0})
    free_memory(torch)
    per_phase["profile_hybrid"] = run_hybrid_profile(torch, runtime, hybrid_cfg)
    none = {k: 0 for k in ("block_quant.quantize", "block_quant.dequantize",
                           "flash_attention.forward", "mamba_scan.forward")}
    per_phase["serve_moe"] = run_serve(torch, runtime, "serve_moe", moe_cfg, none)
    free_memory(torch)
    per_phase["int8_copy_moe"], per_phase["profile_moe"] = run_int8_copy_moe(torch, runtime,
                                                                             moe_cfg)
    # whisper: K3 3 times a layer at prefill (encoder, decoder, cross), 18
    per_phase["serve_audio"] = run_serve(
        torch, runtime, "serve_audio", audio_cfg,
        {**none, "flash_attention.forward": audio_cfg.enc_layers + 2 * audio_cfg.dec_layers},
        batch=AUDIO_BATCH, prompt=AUDIO_PROMPT)
    free_memory(torch)
    per_phase["profile_audio"] = run_serving_profile(torch, runtime, "profile_audio", audio_cfg,
                                                     AUDIO_BATCH, AUDIO_PROMPT)
    vlm_cut = dataclasses.replace(vlm_cfg, num_layers=VLM_SERVE_LAYERS)
    per_phase["serve_vlm"] = run_serve(
        torch, runtime, "serve_vlm", vlm_cut, {**none, "flash_attention.forward": VLM_SERVE_LAYERS},
        peak_gb=VLM_PEAK_GB)
    free_memory(torch)
    per_phase["profile_vlm"] = run_serving_profile(torch, runtime, "profile_vlm", vlm_cut, BATCH,
                                                   PROMPT)
    per_phase["train_step"] = run_train_step(torch, runtime, cfg, "train_step", (11, 7))
    per_phase["train_hybrid"] = run_train_step(torch, runtime, hybrid_cfg, "train_hybrid", (16, 4))
    per_phase["train_ssm"] = run_train_step(
        torch, runtime, dataclasses.replace(ssm_cfg, num_layers=SSM_TRAIN_LAYERS), "train_ssm",
        (9, 3))
    per_phase["train_moe"] = run_train_step(
        torch, runtime, dataclasses.replace(moe_cfg, num_layers=MOE_TRAIN_LAYERS), "train_moe",
        (23, 15))
    per_phase["train_audio"] = run_train_step(torch, runtime, audio_cfg, "train_audio", (24, 18),
                                              batch_size=AUDIO_BATCH, seq=AUDIO_TRAIN_SEQ)
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
         "deepseek_page_class_ms": bq_moe["k1_ms"],
         "deepseek_page_class_bound_ms": bq_moe["k1_bound_ms"],
         "per": "sum over the 7 stacked danube weights, f32 in; train_step_*: over a "
                "training step's 18 launches, the 11 folded gradients and the 7 weights; "
                "deepseek_page_class_*: over deepseek-v2-lite's 15 page-class weights at "
                "full depth, f32 in (plain times on the kernels.block_quant_moe lines)"},
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
         "deepseek_page_class_ms": bq_moe["k2_ms"],
         "deepseek_page_class_bound_ms": bq_moe["k2_bound_ms"],
         "per": "sum over the 7 stacked danube weights, bf16 out; train_step_*: over a "
                "training step's 18 launches, f32 out for the 11 folded gradients; "
                "deepseek_page_class_*: over deepseek-v2-lite's 15 page-class weights, "
                "bf16 out"},
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
         "other_shapes": k3["other_shapes"], "wgmma_ptxas": k3["wgmma_ptxas"],
         "per": f"one launch (one layer) at {k3['shape']}, bf16 (wgmma + TMA); other_shapes: "
                "zamba2's, whisper's (encoder, decoder, cross) and internvl2's serving "
                "shapes, one launch each"},
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
