"""What ``tools/k3_ablation.py`` and ``tools/k4_ablation.py`` share: build
copies of a kernel's ``.cu`` with parts of its work edited out, bind each
copy's entry point, and time the copies in turns.

Each tool keeps only its shape, its source edits and its launch.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def replace(src: str, old: str, new: str) -> str:
    """``src`` with ``old`` replaced; exits naming ``old`` if it is gone."""
    if old not in src:
        raise SystemExit(f"ablation: the source no longer holds {old.strip()!r}")
    return src.replace(old, new)


def build_variants(tool: str, library: str, symbol: str, signature, variants: dict) -> dict:
    """nvcc every ``variants[name](source)`` of the repo's ``library`` source,
    all at once, into ``build/<tool>/``; ``{name: (lib, nvcc output)}`` with
    ``lib.<symbol>`` bound to ``signature``."""
    from repro_torch.kernels import runtime

    src = runtime.SOURCES[library].read_text()
    out = ROOT / "build" / tool
    out.mkdir(parents=True, exist_ok=True)

    def build(name):
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(variants[name](src))
        done = subprocess.run([runtime.nvcc_path(), *runtime.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if done.returncode:
            raise SystemExit(f"{tool}: nvcc failed for {name}:\n{done.stdout}{done.stderr}")
        lib = ctypes.CDLL(str(so))
        getattr(lib, symbol).argtypes = signature
        getattr(lib, symbol).restype = ctypes.c_int
        return name, (lib, done.stdout + done.stderr)

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(build, variants))


def time_in_turns(torch, runs: dict, reps: int = 20, warmup: int = 3) -> dict:
    """CUDA-event medians of every ``runs[name]()``, in forward then reverse
    order, so that drift in the card's clock falls on all alike:
    ``{name: [ms, ms]}``."""
    import chip_smoke as cs

    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(cs.time_ms(torch, runs[name], reps=reps, warmup=warmup))
    return times
