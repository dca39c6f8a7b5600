#!/usr/bin/env python3
"""The dry run of every live (arch, cell) pair on each mesh, one child
process a cell, several at once; prints one JSON line a cell and a summary
line of how many were ``ok`` on each mesh.

    python3 tools/dryrun_sweep.py                              # the port, reduced, CPU
    python3 tools/dryrun_sweep.py --meshes 2x2,16x16,2x2x2
    python3 tools/dryrun_sweep.py --src /path/to/other/checkout/src   # another revision
    python3 tools/dryrun_sweep.py --package repro --meshes 16x16      # the JAX package

Each cell runs ``python -m <package>.launch.dryrun --arch A --cell C --mesh
M [--reduced] --out DIR`` with ``--src`` on its path (``--device cpu`` for
the port: fake CPU tensors; for the JAX package ``REPRO_XLA_FLAGS`` gives it
as many fake CPU devices as the largest mesh has, ``JAX_PLATFORMS=cpu``).
The cells are the live cells of ``repro_torch.configs``, which are the JAX
package's.  Exits 1 if a cell fails.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def cells(archs):
    from repro_torch.configs import ARCHS, get_config

    return [(a, c.name) for a in (archs or list(ARCHS)) for c in get_config(a).live_cells()]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default="repro_torch", choices=["repro_torch", "repro"])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the checkout's src directory")
    ap.add_argument("--meshes", default="2x2,16x16")
    ap.add_argument("--archs", default="", help="comma list (default: every arch)")
    ap.add_argument("--full", action="store_true", help="full size (default: --reduced)")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a cell")
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun_sweep"))
    a = ap.parse_args()
    meshes = a.meshes.split(",")
    jobs = [(arch, cell, m) for m in meshes for arch, cell in cells(a.archs.split(",")
                                                                        if a.archs else None)]
    out = Path(a.out) / a.package
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=a.src, OMP_NUM_THREADS="1")
    if a.package == "repro":
        n = max(math.prod(int(x) for x in m.split("x")) for m in meshes)
        env.update(JAX_PLATFORMS="cpu",
                   REPRO_XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")

    def run(job):
        arch, cell, mesh = job
        cmd = [sys.executable, "-m", f"{a.package}.launch.dryrun", "--arch", arch, "--cell",
               cell, "--mesh", mesh, "--out", str(out)]
        cmd += [] if a.full else ["--reduced"]
        cmd += ["--device", "cpu"] if a.package == "repro_torch" else []
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=a.timeout)
            rc, err = r.returncode, r.stderr
        except subprocess.TimeoutExpired:
            rc, err = None, f"over {a.timeout} s"
        failed = [line for line in err.splitlines() if "FAILED" in line or "Error" in line]
        return {"arch": arch, "cell": cell, "mesh": mesh, "ok": rc == 0,
                "wall_s": time.perf_counter() - t0,
                "error": None if rc == 0 else (failed[-1] if failed else err[-300:])[:300]}

    with ThreadPoolExecutor(a.workers) as pool:
        results = list(pool.map(run, jobs))
    for r in results:
        print(json.dumps(r), flush=True)
    summary = {m: f"{sum(r['ok'] for r in results if r['mesh'] == m)}/"
                  f"{sum(r['mesh'] == m for r in results)}" for m in meshes}
    print(json.dumps({"tool": "dryrun_sweep", "package": a.package, "src": a.src,
                      "reduced": not a.full, "ok_by_mesh": summary}), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
