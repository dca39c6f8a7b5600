#!/usr/bin/env python3
"""Set each captured TPU trace (the JAX package's ``repro.capture``) beside
the port's Hopper trace of the same launch (``repro_torch.capture``), and
replay both in the JAX package's DaeMon simulator.

    PYTHONPATH=src python3 tools/capture_h100.py [--n-accesses 20000] [--out DIR]

Runs on the CPU: it writes the eight traces as ``.npz`` files under ``--out``
(default ``build/capture_h100/``), prints one JSON line per trace (accesses,
bytes moved by operand, footprint, compressibility, summed gaps), then runs
fig8's grid (``repro.core.sim.fig8_kernels``: ``page`` and ``daemon`` at
link_bw_frac 0.125, 0.5 and 1.0) over the registered files and prints one
JSON line per launch and trace with DaeMon's speedup over ``page`` at each
bandwidth and their geomean.  The TPU traces' gaps are priced at the TPU
constant the JAX package uses; the Hopper traces' at the H100's peaks.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro.capture as tpu  # noqa: E402
from repro.core.sim import fig8_kernels  # noqa: E402
from repro.core.sim.runner import KERNEL_BW_FRACS  # noqa: E402

import repro_torch.capture as h100  # noqa: E402

# each JAX catalog entry and the port's Hopper entry of the same launch
PAIRS = (("fa_prefill", "fa_prefill_h100"), ("fa_decode", "fa_decode_h100"),
         ("mamba_fwd", "mamba_fwd_h100"), ("bq_quant", "bq_quant_h100"))


def describe(name: str, res, compressibility: float, path: Path) -> dict:
    return {"trace": name, "path": str(path), "n_accesses": res.n_accesses,
            "moved_bytes": dict(res.moved_bytes), "footprint": res.footprint,
            "compressibility": compressibility, "sum_gaps_cycles": int(res.gaps.sum()),
            "writes": int(res.writes.sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-accesses", type=int, default=20_000,
                    help="accesses a simulated cell (fig8's benchmark default)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "capture_h100")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)

    paths = {}
    for tpu_name, h100_name in PAIRS:
        for name, pkg in ((tpu_name, tpu), (h100_name, h100)):
            path = args.out / f"{name}.npz"
            res = pkg.save_kernel_trace(name, str(path))
            paths[name] = str(path)
            print(json.dumps(describe(name, res, pkg.measured_compressibility_of(name), path)),
                  flush=True)

    rows = fig8_kernels(workloads=tuple(paths.values()), schemes=("page", "daemon"),
                        n_accesses=args.n_accesses)
    by_path = {p: n for n, p in paths.items()}
    speedups = {}
    for r in rows:
        if r["scheme"] == "daemon":
            speedups.setdefault(by_path[r["workload"]], {})[str(r["bw_frac"])] = \
                r["speedup_vs_page"]
    for tpu_name, h100_name in PAIRS:
        for name in (tpu_name, h100_name):
            print(json.dumps({"trace": name, "daemon_speedup_vs_page": speedups[name],
                              "bw_fracs": list(KERNEL_BW_FRACS),
                              "n_accesses": args.n_accesses}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
