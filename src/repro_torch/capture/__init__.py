"""Kernel-trace capture for the Hopper kernels (port of ``repro.capture``).

The port's kernels K1, K3 and K4 describe their own launches (a
``trace_geometry`` shim in each kernel's ``ops.py``, read off its ``.cu``
source) and the recorder turns a launch into the ``(gaps, addrs, writes)``
stream the DaeMon simulator replays, with compute gaps from the H100's
peaks.  The simulator belongs to the JAX package; a trace reaches it as a
standard ``.npz`` file:

    from repro_torch.capture import save_kernel_trace
    save_kernel_trace("fa_prefill_h100", "fa_prefill_h100.npz")
    # then, with the JAX package: repro.core.sim.register_trace_file(path)

Layers: geometry (the Pallas and the Hopper launch descriptions, operand
regions) -> recorder (the TPU grid walk, and the Hopper CTA-scheduler walk)
-> compress (measured payload compressibility) -> workloads (the catalog).
"""
from repro_torch.capture.compress import measure_ratio, measured_compressibility
from repro_torch.capture.geometry import (
    CtaGeometry,
    CtaOperand,
    KernelGeometry,
    Operand,
    assign_regions,
    block_line_addrs,
    tile_line_addrs,
)
from repro_torch.capture.recorder import CaptureResult, CtaTraceRecorder, KernelTraceRecorder
from repro_torch.capture.workloads import (
    CAPTURED,
    CapturedKernel,
    capture,
    capture_meta,
    clear_capture_cache,
    measured_compressibility_of,
    save_kernel_trace,
)

__all__ = [
    "KernelGeometry", "Operand", "CtaGeometry", "CtaOperand", "assign_regions",
    "block_line_addrs", "tile_line_addrs",
    "CaptureResult", "KernelTraceRecorder", "CtaTraceRecorder",
    "measure_ratio", "measured_compressibility",
    "CAPTURED", "CapturedKernel", "capture", "capture_meta", "clear_capture_cache",
    "measured_compressibility_of", "save_kernel_trace",
]
