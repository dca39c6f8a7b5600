"""Run one cell of the benchmark once, on the card of the machine it starts on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; ``readings``, the
check's numbers that hold no limit; ``checks``, each number compared beside
its limit, comes last, and the same numbers are the
last lines of standard error.  ``setup_s`` counts from this file's first
line.  The run exits non-zero and prints no result without a CUDA card (or
with fewer cards than the cell asks for), without the port beside it
(``src/repro_torch``), or when JAX or the JAX package is loaded once the
window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def card_index() -> int:
    """The machine's index of the card this process runs on: the first entry
    of ``CUDA_VISIBLE_DEVICES`` where it is a number, else 0."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return int(first) if first.isdigit() else 0


def cpu_pair(cpus: list, card: int) -> list:
    """Two of ``cpus`` (the CPUs the process may use, sorted) for the card
    ``card``, the first two left to the system: the third and fourth for
    card 0, the next two for card 1, and so on round the rest, so that runs
    on different cards of one machine take different CPUs.  All of ``cpus``
    where there are fewer than four."""
    if len(cpus) < 4:
        return cpus
    start = 2 + 2 * (card % ((len(cpus) - 2) // 2))
    return cpus[start:start + 2]


def pin_cpus() -> None:
    """Hold the process (and every thread it starts) to two of the CPUs it
    was given, chosen by its card: the decode cell is paced by the host, and
    a process left to migrate spread its rate about four times as wide
    between runs as a pinned one (PERF.md)."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpu_pair(cpus, card_index()))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_cpus()

    # every kernel cache under the checkout, at fixed paths
    cache = ROOT / "build" / "bench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench.harness import cells

    cell = cells.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (a checkout without the port stops here)

    from bench.harness.driver import run_cell

    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": dev}
    if args.trace:
        dev["busy_s"], dev["window_s"] = res.get("busy_s"), res.get("window_s")
        if "breakdown" in res:
            line["breakdown"] = res["breakdown"]
        line["trace_diagnostics"] = res.get("trace_diagnostics")
    if res["readings"]:
        line["readings"] = res["readings"]
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in res["checks"].items()}
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
