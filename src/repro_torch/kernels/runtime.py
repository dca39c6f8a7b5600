"""Build, load and count the port's hand-written CUDA kernels.

Each kernel family is one ``<name>/csrc/<name>.cu`` file with a plain C
interface.  ``nvcc`` compiles it for ``sm_90a`` into ``build/repro_torch/`` at
the root of the checkout the first time one of its kernels launches (or all at
once, one ``nvcc`` per source in parallel, through :func:`build`), and
``ctypes`` loads it.  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt.  Nothing here runs at import: the
CPU tests import every module, and there is no ``nvcc`` there.

``LAUNCHES`` counts launches per kernel; a wrapper adds one where it launches
its kernel and nowhere else, so a run can show which kernels its path took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"
SOURCES = {
    "block_quant": _KERNELS / "block_quant" / "csrc" / "block_quant.cu",
    "flash_attention": _KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
    "mamba_scan": _KERNELS / "mamba_scan" / "csrc" / "mamba_scan.cu",
}
# IEEE division and accurate expf: no --use_fast_math (block_quant's codes
# would flip at .5 boundaries; flash_attention is held to 2e-5 in f32).  A
# kernel that wants the SFU's ex2.approx calls it itself, as mamba_scan does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES: Dict[str, int] = {
    "block_quant.quantize": 0,
    "block_quant.dequantize": 0,
    "flash_attention.forward": 0,
    "mamba_scan.forward": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc builds the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named library not built yet, one ``nvcc`` each, all
    started together.  Returns the seconds each build took (0 if cached);
    the compiler's output (``-Xptxas=-v``: registers, shared memory, spills)
    is kept beside the library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with ``argtypes``
    set from ``signatures`` and every function returning a ``cudaError_t``."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def forward_only(kernel: str, *inputs) -> None:
    """Raise if autograd would have to differentiate through ``kernel``: its
    output would carry no ``grad_fn``, and the inputs would get no gradient
    without a word.  The kernels have no backward, as the Pallas ones have none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{kernel} is forward-only, as the Pallas kernel is: call it under "
            "torch.no_grad() or on inputs that do not require grad"
        )


def launch_config(lib: ctypes.CDLL, fn: str, kernel: str, *args) -> Dict[str, object]:
    """What the launch query ``fn`` of ``lib`` reports for ``args``: the grid
    the launcher would use, its threads a CTA and dynamic shared memory, and
    the CTAs an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    on the current card).  Trace capture holds its model of the launch to it."""
    out = (ctypes.c_int * 6)()
    check(lib, getattr(lib, fn)(*args, out), kernel)
    return {"grid": tuple(out[:3]), "threads": out[3], "smem_bytes": out[4],
            "ctas_per_sm": out[5]}


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if the launcher's ``cudaGetLastError()`` was not ``cudaSuccess``."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err}: {lib.repro_error_string(err).decode()}")
