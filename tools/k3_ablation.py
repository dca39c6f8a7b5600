#!/usr/bin/env python3
"""Where K3's bf16 tensor-core kernel spends its time, on one CUDA card.

    python3 tools/k3_ablation.py

Builds copies of ``csrc/flash_attention.cu`` with one part of the bf16
kernel's work taken out, times each at h2o-danube-1.8b's serving shape
(B=2, S=8192, H=32, KVH=8, D=80, window 4096) in turns (forward, then
reverse order, CUDA-event medians), and prints one JSON line per variant with
its time and its excess over the card's bf16 limit (1e-5 + 1e-2|ref|) against
the plain version.  Only ``kernel`` computes attention; the others are wrong
on purpose and say how much time the removed part costs:
  p_rounded_once  one PV product with P rounded once to bf16 (no lo product)
  no_exp          the exp of each score replaced by its argument
  no_softmax      no mask, max, exp, sum or rescale: P = S
  no_tensor_core  no wgmma: the loads, softmax and split alone
  no_kv_loads     K/V loaded once per stage, then reused: no TMA traffic
Needs the card, nvcc and the rest of the repository beside it.
"""
from __future__ import annotations

import json
import math
import sys

from _ablation import build_variants, replace as _replace, time_in_turns

SHAPE = (2, 8192, 8192, 32, 8, 80, True, 4096)  # (B, Sq, Skv, H, KVH, D, causal, window)


def _between(src: str, start: str, end: str, new: str) -> str:
    a, z = src.index(start), src.index(end)
    return src[:a] + new + src[z:]


VARIANTS = {
    "kernel": lambda s: s,
    "p_rounded_once": lambda s: _replace(s, "      wgmma_rs<1>(o, p_lo[kk], dv);\n", ""),
    "no_exp": lambda s: _replace(s, "sc[j] = fast_exp2(fmaf(sc[j], p.scale_log2, neg_max[r]));",
                                 "sc[j] = fmaf(sc[j], p.scale_log2, neg_max[r]);"),
    "no_softmax": lambda s: _between(s, "    float row_max[2] = {kNegInf, kNegInf};",
                                     "    if (i > 0) {\n      wgmma_wait<0>();",
                                     "    const float alpha[2] = {1.f, 1.f};\n"),
    "no_tensor_core": lambda s: _replace(_replace(
        s, "wgmma_rs<0>(sc, q_frag[kk], make_desc(k_addr + 2 * kk * kSlabKV, kSlabKV, 128));",
        "(void)k_addr;"),
        "      wgmma_rs<1>(o, p_hi[kk], dv);\n      wgmma_rs<1>(o, p_lo[kk], dv);", "      (void)dv;"),
    "no_kv_loads": lambda s: _replace(
        s, "      if (lane == 0) mbar_expect_tx(&full[s], 2 * L::kKVBytes);",
        "      if (i >= kTcStages) {\n        if (lane == 0) mbar_arrive(&full[s]);\n"
        "        continue;\n      }\n"
        "      if (lane == 0) mbar_expect_tx(&full[s], 2 * L::kKVBytes);"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import kernel, ref

    libs = build_variants("k3_ablation", "flash_attention", "fa_forward",
                          kernel._SIGNATURES["fa_forward"], VARIANTS)

    b, sq, skv, h, kvh, d, causal, window = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, skv, kvh, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, skv, kvh, d, generator=gen, device="cuda").bfloat16()
    o = torch.empty_like(q)
    expect = ref.attention_ref(q, k, v, causal=causal, window=window).float()

    def run(lib):
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                             b, sq, skv, h, kvh, d, *q.stride()[:3], *k.stride()[:3],
                             *v.stride()[:3], int(causal), window, 1.0 / math.sqrt(d),
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k3_ablation: launch failed with CUDA error {err}")

    times = time_in_turns(torch, {name: (lambda lib=lib: run(lib))
                                  for name, (lib, _) in libs.items()})
    print(cs.nvidia_smi(), flush=True)
    for name, (lib, _) in libs.items():
        run(lib)
        torch.cuda.synchronize()
        excess = float(((o.float() - expect).abs() - 1e-2 * expect.abs()).max())
        print(json.dumps({"variant": name, "shape": list(SHAPE), "ms": min(times[name]),
                          "ms_runs": times[name], "excess_over_1e-2_ref": excess}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
