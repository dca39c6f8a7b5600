"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line's contents.

The traffic file's ``kind`` names the module under ``bench/kinds`` that
drives the port; a per-layer metric's name names its reader under
``bench/metrics``.  Readers that find nothing to read return None, and the
metric is left out of the line.
"""
from __future__ import annotations

import importlib
import importlib.util
import math
import time

import torch

from bench.harness.cells import BENCH, Cell
from bench.harness.trace import Tracer


def kind_module(kind: str):
    return importlib.import_module(f"bench.kinds.{kind}")


def reader(metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for every number the limits file holds."""
    out = {}
    for name, lim in limits["numbers"].items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= lim["limit"]
        out[name] = {"value": value, "limit": lim["limit"], "ok": ok}
    return out


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Run ``cell`` once; ``t0``: the process's start on ``time.perf_counter``.
    -> {"correct", "attempted", "failed", "metrics", "peak_bytes", "checks",
    "breakdown"?, "busy_s"?, "window_s"?}."""
    kind = kind_module(cell.traffic["kind"]).Kind(cell.cfg, cell.traffic, seed, device)
    first, count = cell.traffic["trace_units"]
    tracer = Tracer(trace, first, count, device)
    kind.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        setup_peak = _peak(device)
        torch.cuda.reset_peak_memory_stats(device)
    else:
        setup_peak = 0
    setup_s = time.perf_counter() - t0
    kind.window(seconds, tracer)
    tracer.stop()
    window_peak = _peak(device)
    e2e = dict(kind.end_to_end(), setup_s=setup_s, peak_mem_gb=window_peak / 1e9)
    summary = None
    if trace:
        kind_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        summary = tracer.summary(cell.cfg, cell.traffic, kind_name)
    kind.release()
    numbers = kind.check()
    checks = judge(numbers, cell.limits)
    out = {
        "correct": all(c["ok"] for c in checks.values()) and kind.failed == 0,
        "attempted": kind.attempted,
        "failed": kind.failed,
        "peak_bytes": max(setup_peak, window_peak),
        "checks": checks,
        "readings": {k: v for k, v in numbers.items() if k not in checks},
    }
    if not trace:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
        return out
    metrics = {}
    if summary is not None and tracer.complete:
        for m in cell.per_layer:
            value = reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["busy_s"], out["window_s"] = summary.busy_s, summary.window_s
        out["breakdown"] = {
            "device_ops": sorted(([k, ms / 1e3] for k, (ms, _) in summary.kernels.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": summary.gaps[:10],
        }
        out["trace_diagnostics"] = {"units": len(summary.units),
                                    "launches": summary.launches,
                                    "unattributed_device_ms": sum(summary.unattributed.values()),
                                    "attributed_via": summary.attributed_via}
    out["metrics"] = metrics
    return out
