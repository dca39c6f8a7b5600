#!/usr/bin/env python3
"""Where K4 (the selective scan) spends its time, on one CUDA card.

    python3 tools/k4_ablation.py

Builds copies of ``csrc/mamba_scan.cu`` with one part of the kernel's work
taken out, or done another way, times each at falcon-mamba-7b's serving
shape (B=2, S=8192, D=8192, N=16, x bf16) in turns (forward, then reverse
order, CUDA-event medians), and prints one JSON line per variant with its
time, its registers and spills (ptxas) and, for the variants that compute
the scan, the excess of y and h_last over K4's limit (1e-4 + 1e-4|ref|)
against the plain version.  The variants that compute the scan are also
timed, in turns, at B=1 (the first batch row of the same inputs): half the
blocks, so K4's layout no longer puts two blocks on every SM.
  kernel        K4 as built: two lanes a channel
  one_lane      one thread a channel, all N states (one warp a scheduler)
  four_lanes    four lanes a channel (N/4 states each, two shuffles)
  poly_exp      every 8th state's exp on the FMA pipe (a degree-5
                polynomial, relative error 2.1e-7) instead of the SFU
  hoisted_addr  the copies' addresses left to ptxas, which hoists them out of
                the chunk loop into registers
  stage_96      96 steps a stage: the ring no longer lets two blocks share
                an SM
  four_stages   a 4-stage ring, likewise
The others are wrong on purpose and say how much time the removed part costs:
  no_exp        exp replaced by one FADD (da = 1 + dt·A'): no SFU work
  no_y          no C product, no shuffle and no y store
  no_hbm_loads  no copies after the ring's first stages: every chunk reads
                stale stages, so no HBM traffic but y's stores
  state_alone   no exp, no y, no loads: the state update h = da·h + dx·B
Needs the card, nvcc and the rest of the repository beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys

from _ablation import build_variants, replace as _replace, time_in_turns

SHAPE = (2, 8192, 8192, 16)  # (B, S, D, N)

_EXP = '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));\n'
_Y = ("        yv = fmaf(h[j], cv[j], yv);\n", "      if (live && n0 == 0) *yp = yv;\n")
_LOADS = "    if (kn < chunks) stage_in<TX, N>(ring[kn % kStages], p, row0, kn * kT, c0);\n"
_LANES = "constexpr int kLanes = 2;"
_TID = '  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));\n'
_SMEM_ADDR = "__device__ __forceinline__ uint32_t smem_addr"
# 2^v for v >= -126 on the FMA pipe: v = j + f, |f| <= 1/2; 2^f by a degree-5
# minimax polynomial (2.1e-7 relative in f32); 2^j added to the exponent bits
_POLY = """__device__ __forceinline__ float poly_exp2(float v) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  v = fmaxf(v, -126.f);
  const float t = v + kRound;
  const float f = v - (t - kRound);
  float q = 0.00132764725f;
  q = fmaf(q, f, 0.00967554096f);
  q = fmaf(q, f, 0.0555071309f);
  q = fmaf(q, f, 0.240221202f);
  q = fmaf(q, f, 0.693146944f);
  q = fmaf(q, f, 1.00000012f);
  return __uint_as_float(__float_as_uint(q) + (__float_as_uint(t) << 23));
}

"""


def _poly_exp(s: str) -> str:
    s = _replace(s, _SMEM_ADDR, _POLY + _SMEM_ADDR)
    for d in ("st.dt[0][cl]", "d1"):
        s = _replace(s, f"= fast_exp2({d} * a2[j]);",
                     f"= j % 8 == 7 ? poly_exp2({d} * a2[j]) : fast_exp2({d} * a2[j]);")
    return s


def _no_exp(s: str) -> str:
    return _replace(s, _EXP, "  r = v + 1.f;\n")


def _no_y(s: str) -> str:
    return _replace(_replace(s, _Y[0], ""), _Y[1], "")


def _no_loads(s: str) -> str:
    return _replace(s, _LOADS, "")


VARIANTS = {
    "kernel": lambda s: s,
    "one_lane": lambda s: _replace(s, _LANES, "constexpr int kLanes = 1;"),
    "four_lanes": lambda s: _replace(s, _LANES, "constexpr int kLanes = 4;"),
    "poly_exp": _poly_exp,
    "hoisted_addr": lambda s: _replace(s, _TID, "  tid = threadIdx.x;\n"),
    "stage_96": lambda s: _replace(s, "constexpr int kT = 64;", "constexpr int kT = 96;"),
    "four_stages": lambda s: _replace(s, "constexpr int kStages = 3;", "constexpr int kStages = 4;"),
    "no_exp": _no_exp,
    "no_y": _no_y,
    "no_hbm_loads": _no_loads,
    "state_alone": lambda s: _no_loads(_no_y(_no_exp(s))),
}
COMPUTES = ("kernel", "one_lane", "four_lanes", "poly_exp", "hoisted_addr", "stage_96",
            "four_stages")  # the variants that compute the scan, held to K4's limit


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k4_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.mamba_scan import kernel, ref

    built = build_variants("k4_ablation", "mamba_scan", "ms_forward",
                           kernel._SIGNATURES["ms_forward"], VARIANTS)
    libs = {name: (lib, {k: v for k, v in cs.ptxas_per_kernel(log).items() if "bf16, 16" in k})
            for name, (lib, log) in built.items()}

    b, s, d, n = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn(b, s, d, generator=gen, device="cuda").bfloat16()
    bm = torch.randn(b, s, n, generator=gen, device="cuda")
    cm = torch.randn(b, s, n, generator=gen, device="cuda")
    a = -torch.exp(torch.randn(d, n, generator=gen, device="cuda") * 0.5)
    dt = F.softplus(torch.randn(b, s, d, generator=gen, device="cuda") - 1.0)
    y = torch.empty(b, s, d, device="cuda")
    h = torch.empty(b, d, n, device="cuda")
    y_ref, h_ref = ref.selective_scan_ref(dt, a, bm, cm, x)

    def excess(got, expect):
        return float(((got - expect).abs() - 1e-4 * expect.abs()).max())

    def run(lib, batch=b):  # the first ``batch`` rows of the inputs
        err = lib.ms_forward(dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                             x.data_ptr(), 1, y.data_ptr(), h.data_ptr(), batch, s, d, n,
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k4_ablation: launch failed with CUDA error {err}")

    times = time_in_turns(torch, {name: (lambda lib=lib: run(lib))
                                  for name, (lib, _) in libs.items()})
    times_b1 = time_in_turns(torch, {name: (lambda lib=libs[name][0]: run(lib, 1))
                                     for name in COMPUTES})
    print(cs.nvidia_smi(), flush=True)
    for _ in range(1000):  # ~0.8 s of K4 queued: read the clock under its load
        run(libs["kernel"][0])
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    print(json.dumps({"under_load": "clocks.sm, clocks.max.sm, power.draw",
                      "nvidia_smi": clocks.stdout.strip()}), flush=True)
    for name, (lib, ptxas) in libs.items():
        row = {"variant": name, "shape": list(SHAPE), "ms": min(times[name]),
               "ms_runs": times[name], "ptxas": ptxas}
        if name in COMPUTES:
            run(lib)
            torch.cuda.synchronize()
            for label, got, expect in (("y", y, y_ref), ("h_last", h, h_ref)):
                row[f"{label}_excess_over_1e-4_ref"] = excess(got, expect)
        print(json.dumps(row), flush=True)
    for name in COMPUTES:
        y.zero_()
        h.zero_()
        run(libs[name][0], 1)
        torch.cuda.synchronize()
        print(json.dumps({"variant": name, "shape": [1, s, d, n], "ms": min(times_b1[name]),
                          "ms_runs": times_b1[name],
                          "y_excess_over_1e-4_ref": excess(y[:1], y_ref[:1]),
                          "h_last_excess_over_1e-4_ref": excess(h[:1], h_ref[:1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
