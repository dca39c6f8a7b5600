"""The port's captured-kernel catalog: K1, K3 and K4's own Hopper launches
as DaeMon-simulator traces, at the launch shapes of the JAX package's catalog
(``repro.capture.workloads``), so a TPU trace and a Hopper trace of one
launch can be set side by side:

  fa_prefill_h100  K3, 512-token causal GQA prefill (B 1, 4/2 heads of 64)
  fa_decode_h100   K3, one query row a head against a 512-key cache (B 4,
                   2/1 heads of 128), non-causal: K3's causal mask is aligned
                   top-left, so a causal one-row query would see key 0 only,
                   where a decode query sees the whole cache
  mamba_fwd_h100   K4, B 1, S 1024, D 512, N 16, x in bf16
  bq_quant_h100    K1, a 512 x 2048 f32 tensor

The simulator belongs to the JAX package; the port hands it a trace as a
standard ``.npz`` file (:func:`save_kernel_trace`), which
``repro.core.sim.register_trace_file`` reads.  Kernel modules are imported
at the first capture, and a capture builds and loads no CUDA library.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.capture.compress import measured_compressibility
from repro_torch.capture.recorder import CaptureResult, CtaTraceRecorder


@dataclass(frozen=True)
class CapturedKernel:
    """A named kernel launch whose geometry is built at its first capture."""

    name: str
    module: str  # the kernel's ops module carrying the trace_geometry shim
    config: Dict[str, object]  # kwargs for the shim
    description: str = ""

    def build_geometry(self):
        return importlib.import_module(self.module).trace_geometry(**self.config)


CAPTURED: Dict[str, CapturedKernel] = {}
_RESULTS: Dict[str, CaptureResult] = {}  # per-process capture cache


def _catalog(name: str, module: str, description: str, **config) -> None:
    CAPTURED[name] = CapturedKernel(name=name, module=module, config=config,
                                    description=description)


_FA = "repro_torch.kernels.flash_attention.ops"
_MS = "repro_torch.kernels.mamba_scan.ops"
_BQ = "repro_torch.kernels.block_quant.ops"

_catalog("fa_prefill_h100", _FA,
         "K3 on the H100: causal GQA prefill, Q in registers over a 4-stage K/V ring",
         b=1, sq=512, skv=512, h=4, kvh=2, d=64, causal=True, variant="prefill")
_catalog("fa_decode_h100", _FA,
         "K3 on the H100: one query row a head, the 512-key cache streamed",
         b=4, sq=1, skv=512, h=2, kvh=1, d=128, causal=False, variant="decode")
_catalog("mamba_fwd_h100", _MS,
         "K4 on the H100: A once a block, dt/x/B/C staged 3 deep, y each stage",
         b=1, s=1024, d=512, n=16, variant="fwd")
_catalog("bq_quant_h100", _BQ,
         "K1 on the H100: 8 contiguous f32 blocks a CTA, int8 codes and scales out",
         r=512, c=2048, variant="quant")


def capture(name: str) -> CaptureResult:
    """Run (or fetch the cached) capture of one catalog entry."""
    res = _RESULTS.get(name)
    if res is None:
        entry = CAPTURED.get(name)
        if entry is None:
            raise KeyError(f"unknown captured kernel {name!r}; catalog: {', '.join(CAPTURED)}")
        res = _RESULTS[name] = CtaTraceRecorder(entry.build_geometry()).record()
    return res


def clear_capture_cache() -> None:
    """Drop cached captures (tests re-deriving traces from scratch)."""
    _RESULTS.clear()


def measured_compressibility_of(name: str) -> float:
    return measured_compressibility(capture(name))


def capture_meta(name: str) -> Dict[str, object]:
    """Source-kernel metadata of one captured launch."""
    res = capture(name)
    geom = res.geom
    return {
        "kernel": geom.kernel,
        "variant": geom.variant,
        "grid": geom.grid,
        "threads": geom.threads,
        "ctas_per_sm": geom.ctas_per_sm,
        "operands": tuple(op.name for op in geom.operands),
        "n_accesses": res.n_accesses,
        "footprint": res.footprint,
        "moved_bytes": dict(res.moved_bytes),
        "config": dict(CAPTURED[name].config),
        "compressibility": measured_compressibility_of(name),
    }


def save_kernel_trace(name: str, path: str) -> CaptureResult:
    """Write one captured trace as the simulator's ``.npz`` replay file: the
    keys and dtypes of ``repro.core.sim.trace.save_trace`` (int64 gaps and
    addrs, bool writes, f64 compressibility)."""
    res = capture(name)
    np.savez(path, gaps=np.asarray(res.gaps, np.int64), addrs=np.asarray(res.addrs, np.int64),
             writes=np.asarray(res.writes, bool),
             compressibility=np.float64(measured_compressibility_of(name)))
    return res
