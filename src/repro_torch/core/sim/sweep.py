"""Declarative parallel sweep engine for the DS simulator (DESIGN.md §6).

The paper's headline results are grids — schemes x workloads x network
configurations — and its core claim is robustness *across* those axes.  This
module turns every such grid into one declarative :class:`Sweep`:

    sweep = Sweep(
        name="fig2",
        axes={"workload": ("pr", "st"), "scheme": ("page", "daemon"),
              "link_bw_frac": (0.25, 0.125)},
    )
    result = run_sweep(sweep, workers=8)     # process-pool fan-out
    result.save_json("fig2.json")            # standalone artifact
    write_bench("build/sim.json", result)    # merge into a bench ledger

Axis names are ``scheme`` / ``workload`` / ``seed`` / ``n_jobs`` plus any
:class:`SimConfig` field (``link_bw_frac``, ``n_mcs``, ``bw_jitter``, ...).
Cells are the cartesian product in declaration order.  Each cell is an
independent simulation with deterministic seeding (a pure function of the
cell's axis values), so a parallel run is cell-for-cell identical to a
serial run of the same sweep — verified by tests/test_sweep.py.
"""
from __future__ import annotations

import itertools
import json
import os
import time
import zlib
from concurrent.futures import ProcessPoolExecutor
from dataclasses import asdict, dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.sim.config import Metrics, SimConfig
from repro_torch.core.sim.controller import get_controller
from repro_torch.core.sim.engine import simulate
from repro_torch.core.sim.engine_batch import BatchCell, covers, run_batch
from repro_torch.core.sim.memside import get_placement
from repro_torch.core.sim.policy import MovementPolicy, get_policy
from repro_torch.core.sim.serving import get_router, serve_one
from repro_torch.core.sim.trace import generate, get_workload

BENCH_SCHEMA = "repro.sim.sweep/v1"

# cell execution engines: "python" is the per-cell oracle event loop,
# "batch" the lockstep struct-of-arrays core (engine_batch.py) with
# automatic per-cell fallback to the oracle for uncovered configs
ENGINES = ("python", "batch")

# axes consumed by the cell runner itself; everything else must be a
# SimConfig field and is applied with cfg.with_()
RESERVED_AXES = ("scheme", "workload", "seed", "n_jobs")


# --------------------------------------------------------------------------
# cell primitive
# --------------------------------------------------------------------------


def run_one(
    workload: str,
    scheme,
    cfg: Optional[SimConfig] = None,
    *,
    seed: int = 0,
    n_accesses: int = 60_000,
    footprint: int = 16 << 20,
    n_jobs: int = 1,
) -> Metrics:
    """One application = cfg.n_cores threads of the workload (multicore CC);
    n_jobs > 1 stacks additional independent applications on the same CC.
    ``scheme`` is a registered policy name or a
    :class:`~repro_torch.core.sim.policy.MovementPolicy` instance; ``workload``
    names registered trace sources (unknown names fail fast listing the
    registered choices).

    With ``cfg.n_ccs > 1`` every CC runs its own full application
    (``n_accesses`` is per CC, so aggregate traffic scales with the CC
    count — the contention the multi-CC model measures).  ``workload`` may
    be a '+'-separated mix ('pr+st'): CC ``c`` runs ``parts[c % len(parts)]``,
    so with fewer CCs than parts the tail parts do NOT run (a 4-part mix at
    n_ccs=1 is a pure parts[0] run) and the workload composition of a mix
    varies with n_ccs.  Scheme comparisons at a fixed (mix, n_ccs) cell are
    always composition-matched; trend reads *across* n_ccs are
    composition-stable only for mixes whose length divides every compared
    CC count (e.g. a single workload).  CC 0's trace seeds match the
    single-CC model exactly."""
    cfg = cfg or SimConfig()
    scheme = get_policy(scheme)  # fail fast on unknown policy names
    if cfg.serving_router is not None:
        # open-loop serving cell (DESIGN.md §2.9): the request layer builds
        # its own phase traces from cfg.{prefill,decode}_* — ``workload``,
        # ``n_accesses``, ``footprint`` and ``n_jobs`` do not apply
        return serve_one(cfg, scheme, seed=seed)
    n_ccs = max(1, cfg.n_ccs)
    parts = tuple(workload.split("+")) if workload else (workload,)
    for p in parts:  # fail fast on unknown workload names
        get_workload(p)
    n_threads = max(1, cfg.n_cores) * max(1, n_jobs)
    per = max(1, n_accesses // n_threads)
    if n_ccs == 1 and len(parts) == 1:
        traces = [generate(workload, seed=seed + j, footprint=footprint, n=per)
                  for j in range(n_threads)]
        return simulate(cfg, scheme, traces, workload=workload, seed=seed)
    cc_traces = [
        [generate(parts[c % len(parts)], seed=seed + c * n_threads + j,
                  footprint=footprint, n=per)
         for j in range(n_threads)]
        for c in range(n_ccs)
    ]
    return simulate(cfg, scheme, cc_traces, workload=workload, seed=seed)


# --------------------------------------------------------------------------
# sweep spec
# --------------------------------------------------------------------------


def cell_seed(axes: Mapping[str, Any], base_seed: int = 0) -> int:
    """Deterministic per-cell seed: a pure function of the cell's axis values
    (stable across processes, Python versions, and execution order)."""
    blob = json.dumps({k: axes[k] for k in sorted(axes)}, sort_keys=True,
                      default=str).encode()
    return (base_seed + zlib.crc32(blob)) % (1 << 31)


@dataclass(frozen=True)
class Sweep:
    """Declarative grid of simulator cells (cartesian product of ``axes``).

    ``derive_seeds=False`` (default) runs every cell at ``base_seed`` (or the
    explicit ``seed`` axis) — required when cells are later compared ratio-
    style against each other on identical traces.  ``derive_seeds=True``
    mixes a hash of the cell's axes — excluding ``scheme``, which never
    influences the trace — into the seed, so cells draw decorrelated traces
    across seeds/workloads/configs while cells differing only in scheme
    still run the SAME traces: variance studies keep scheme-ratio
    comparisons trace-paired."""

    name: str
    axes: Mapping[str, Sequence[Any]]
    base: SimConfig = SimConfig()
    n_accesses: int = 60_000  # matches run_one's default
    footprint: int = 16 << 20
    base_seed: int = 0
    derive_seeds: bool = False
    engine: str = "python"  # see ENGINES; overridable per run_sweep call

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; choose one of {ENGINES}")
        for k, v in self.axes.items():
            if k not in RESERVED_AXES and k not in SimConfig.__dataclass_fields__:
                raise ValueError(f"unknown sweep axis {k!r}")
            if isinstance(v, (str, bytes)):
                raise ValueError(
                    f"axis {k!r} must be a sequence of values, not {v!r} "
                    f"(did you mean ({v!r},)?)")
        # fail fast on unknown policy/workload names (registry lookups list
        # the available choices), at declaration time rather than mid-sweep
        for s in self.axes.get("scheme", ()):
            if isinstance(s, MovementPolicy):
                raise ValueError(
                    f"scheme axis values must be registered policy names; "
                    f"register_policy({s.name!r}) first")
            get_policy(s)
        for mix in self.axes.get("workload", ()):
            for part in mix.split("+"):
                get_workload(part)
        for r in self.axes.get("serving_router", ()):
            if r is not None:
                get_router(r)
        for ax in ("controller", "serving_prefill_controller",
                   "serving_decode_controller"):
            for c in self.axes.get(ax, ()):
                if c is not None:
                    get_controller(c)
        for p in self.axes.get("mc_interleave", ()):
            get_placement(p)
        object.__setattr__(self, "axes", {k: tuple(v) for k, v in self.axes.items()})

    def cells(self) -> List[Dict[str, Any]]:
        keys = list(self.axes)
        return [dict(zip(keys, combo))
                for combo in itertools.product(*(self.axes[k] for k in keys))]

    def __len__(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= len(v)
        return n


@dataclass
class CellResult:
    axes: Dict[str, Any]
    metrics: Metrics
    seed: int
    cpu_s: float = 0.0  # this cell's own CPU time, measured inside the worker

    def as_dict(self) -> dict:
        return {"axes": self.axes, "seed": self.seed, "cpu_s": self.cpu_s,
                "metrics": self.metrics.as_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "CellResult":
        return cls(axes=dict(d["axes"]), seed=int(d.get("seed", 0)),
                   cpu_s=float(d.get("cpu_s", 0.0)),
                   metrics=Metrics.from_dict(d["metrics"]))


def _resolve_cell(sweep: Sweep, cell: Dict[str, Any]) -> Tuple[SimConfig, int]:
    """Cell axes -> (SimConfig, seed): the single definition both engines
    share, so the batch path cannot drift from the oracle path."""
    cfg_kw = {k: v for k, v in cell.items() if k not in RESERVED_AXES}
    cfg = sweep.base.with_(**cfg_kw) if cfg_kw else sweep.base
    seed = int(cell.get("seed", sweep.base_seed))
    if sweep.derive_seeds:
        # exclude 'scheme': it never influences trace generation, and
        # hashing it would unpair the traces that scheme-ratio comparisons
        # (scheme_ratio/scheme_geomean) divide against each other
        seed = cell_seed({k: v for k, v in cell.items() if k != "scheme"},
                         base_seed=seed)
    return cfg, seed


def _to_batch_cell(sweep: Sweep, cell: Dict[str, Any]) -> BatchCell:
    cfg, seed = _resolve_cell(sweep, cell)
    return BatchCell(cell.get("workload", "pr"), cell.get("scheme", "daemon"),
                     cfg, seed=seed, n_accesses=sweep.n_accesses,
                     footprint=sweep.footprint,
                     n_jobs=int(cell.get("n_jobs", 1)))


def _run_cell(payload: Tuple[Sweep, Dict[str, Any]]) -> CellResult:
    """Top-level (picklable) worker: execute one sweep cell on the oracle."""
    sweep, cell = payload
    cfg, seed = _resolve_cell(sweep, cell)
    t0 = time.process_time()  # CPU time: robust to pool oversubscription
    m = run_one(
        cell.get("workload", "pr"),
        cell.get("scheme", "daemon"),
        cfg,
        seed=seed,
        n_accesses=sweep.n_accesses,
        footprint=sweep.footprint,
        n_jobs=int(cell.get("n_jobs", 1)),
    )
    return CellResult(axes=cell, metrics=m, seed=seed,
                      cpu_s=time.process_time() - t0)


def _run_batch_group(
    payload: Tuple[Sweep, List[Tuple[int, Dict[str, Any]]]],
) -> List[Tuple[int, CellResult]]:
    """Top-level (picklable) worker: run a group of covered cells through the
    batch engine in one lockstep pass, returning (row_index, CellResult)
    pairs.  Per-cell cpu_s is measured inside the batch driver."""
    sweep, idx_cells = payload
    bcells = [_to_batch_cell(sweep, cell) for _, cell in idx_cells]
    br = run_batch(bcells)
    return [
        (i, CellResult(axes=cell, metrics=m, seed=bc.seed, cpu_s=cpu))
        for (i, cell), bc, m, cpu in zip(idx_cells, bcells, br.metrics,
                                         br.cpu_s)
    ]


def _trace_signature(bc: BatchCell) -> tuple:
    """Trace-shape signature: cells with equal signatures replay the same
    prepared traces, so they belong in the same worker's TracePool."""
    cfg = bc.cfg
    return (bc.workload, bc.seed, bc.footprint, bc.n_accesses, bc.n_jobs,
            max(1, cfg.n_cores), max(1, cfg.n_ccs), cfg.gap_scale)


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------


@dataclass
class SweepResult:
    name: str
    axes: Dict[str, tuple]
    rows: List[CellResult]
    wall_s: float = 0.0
    workers: int = 1
    engine: str = "python"  # which cell engine produced the rows
    # provenance: the Sweep spec that produced the rows (base SimConfig,
    # n_accesses, footprint, seed policy) so ledger entries are reproducible
    spec: Optional[Dict[str, Any]] = None

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    @property
    def us_per_call(self) -> float:
        """Mean per-cell CPU time in µs, measured inside each worker — i.e.
        simulation cost, independent of how many workers ran the sweep or how
        oversubscribed they were (``wall_s`` is the elapsed wall-clock of the
        whole sweep)."""
        if not self.rows:
            return 0.0
        return sum(r.cpu_s for r in self.rows) * 1e6 / len(self.rows)

    def filter(self, **axes) -> List[CellResult]:
        return [r for r in self.rows
                if all(r.axes.get(k) == v for k, v in axes.items())]

    def grid(self, *keys: str) -> Dict[tuple, CellResult]:
        """Index rows by a tuple of axis values, e.g. grid('workload','scheme')."""
        return {tuple(r.axes[k] for k in keys): r for r in self.rows}

    # -------- persistence (docs/SWEEPS.md describes the schema) --------
    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "axes": {k: list(v) for k, v in self.axes.items()},
            "spec": self.spec,
            "wall_s": self.wall_s,
            "workers": self.workers,
            "engine": self.engine,
            "n_cells": len(self.rows),
            "rows": [r.as_dict() for r in self.rows],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SweepResult":
        return cls(
            name=d["name"],
            axes={k: tuple(v) for k, v in d["axes"].items()},
            rows=[CellResult.from_dict(r) for r in d["rows"]],
            wall_s=float(d.get("wall_s", 0.0)),
            workers=int(d.get("workers", 1)),
            engine=str(d.get("engine", "python")),
            spec=d.get("spec"),
        )

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load_json(cls, path: str) -> "SweepResult":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def default_workers() -> int:
    """Worker count: REPRO_SWEEP_WORKERS env override, else the cores this
    process may actually run on (cgroup/affinity-aware where available)."""
    env = os.environ.get("REPRO_SWEEP_WORKERS")
    if env:
        return max(1, int(env))
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


def _run_cells_batch(sweep: Sweep, cells: List[Dict[str, Any]],
                     workers: int) -> List[CellResult]:
    """Batch-engine execution plan: covered cells advance in lockstep
    (grouped so cells sharing a trace-shape signature land in the same
    worker's TracePool), uncovered cells fall back to the oracle cell
    runner.  Row order matches ``cells`` and results are bit-identical to
    the python engine regardless of ``workers``."""
    covered: List[Tuple[int, Dict[str, Any]]] = []
    fallback: List[Tuple[int, Dict[str, Any]]] = []
    sigs: Dict[int, tuple] = {}
    for i, cell in enumerate(cells):
        bc = _to_batch_cell(sweep, cell)
        if covers(bc.cfg, bc.scheme):
            covered.append((i, cell))
            sigs[i] = _trace_signature(bc)
        else:
            fallback.append((i, cell))
    rows: List[Optional[CellResult]] = [None] * len(cells)
    if workers == 1:
        for i, res in _run_batch_group((sweep, covered)):
            rows[i] = res
        for i, cell in fallback:
            rows[i] = _run_cell((sweep, cell))
        return rows
    # parallel: one batch group per worker, filled signature-by-signature
    # (largest first, into the least-loaded bucket) so trace sharing stays
    # intra-worker while the cell count stays balanced
    groups: Dict[tuple, List[Tuple[int, Dict[str, Any]]]] = {}
    for i, cell in covered:
        groups.setdefault(sigs[i], []).append((i, cell))
    n_buckets = min(workers, len(groups)) or 1
    buckets: List[List[Tuple[int, Dict[str, Any]]]] = [[] for _ in
                                                       range(n_buckets)]
    sizes = [0] * n_buckets
    for g in sorted(groups.values(), key=len, reverse=True):
        j = sizes.index(min(sizes))
        buckets[j].extend(g)
        sizes[j] += len(g)
    with ProcessPoolExecutor(max_workers=workers) as pool:
        futs = [pool.submit(_run_batch_group, (sweep, b))
                for b in buckets if b]
        fb = pool.map(_run_cell, [(sweep, c) for _, c in fallback],
                      chunksize=1)
        for fut in futs:
            for i, res in fut.result():
                rows[i] = res
        for (i, _), res in zip(fallback, fb):
            rows[i] = res
    return rows


def run_sweep(sweep: Sweep, workers: Optional[int] = None,
              engine: Optional[str] = None) -> SweepResult:
    """Execute every cell of ``sweep``; ``workers<=1`` runs serial in-process,
    otherwise cells fan out over a process pool.  ``engine`` overrides
    ``sweep.engine`` ("python" = per-cell oracle, "batch" = lockstep batch
    core with oracle fallback for uncovered cells).  Row order always
    matches ``sweep.cells()`` and per-cell results are independent of both
    ``workers`` and ``engine``."""
    cells = sweep.cells()
    eng = sweep.engine if engine is None else engine
    if eng not in ENGINES:
        raise ValueError(f"unknown engine {eng!r}; choose one of {ENGINES}")
    t0 = time.perf_counter()
    if workers is None:
        workers = 1
    workers = max(1, min(workers, len(cells) or 1))
    if eng == "batch":
        rows = _run_cells_batch(sweep, cells, workers)
    elif workers == 1:
        rows = [_run_cell((sweep, c)) for c in cells]
    else:
        # chunksize=1: cell costs vary by >10x across schemes/bandwidths, so
        # dynamic single-cell dispatch beats static chunking; IPC cost per
        # cell (~ms) is noise next to a cell (~100ms+)
        with ProcessPoolExecutor(max_workers=workers) as pool:
            rows = list(pool.map(_run_cell, [(sweep, c) for c in cells],
                                 chunksize=1))
    spec = {
        "base": asdict(sweep.base),
        "n_accesses": sweep.n_accesses,
        "footprint": sweep.footprint,
        "base_seed": sweep.base_seed,
        "derive_seeds": sweep.derive_seeds,
    }
    return SweepResult(name=sweep.name, axes=dict(sweep.axes), rows=rows,
                       wall_s=time.perf_counter() - t0, workers=workers,
                       engine=eng, spec=spec)


# --------------------------------------------------------------------------
# derived statistics
# --------------------------------------------------------------------------


def geomean(xs: Iterable[float]) -> float:
    import math

    xs = [max(x, 1e-12) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def scheme_ratio(
    rows: Iterable[CellResult],
    num: str = "page",
    den: str = "daemon",
    metric: str = "cycles",
) -> Dict[tuple, float]:
    """Pair cells that differ only in ``scheme`` and return num/den ratios
    keyed by the remaining axis values (>1 means ``den`` wins on cycles)."""
    by_key: Dict[tuple, Dict[str, CellResult]] = {}
    for r in rows:
        key = tuple((k, v) for k, v in sorted(r.axes.items()) if k != "scheme")
        by_key.setdefault(key, {})[r.axes.get("scheme", "")] = r
    out = {}
    for key, pair in by_key.items():
        if num in pair and den in pair:
            a = getattr(pair[num].metrics, metric)
            b = getattr(pair[den].metrics, metric)
            out[key] = a / max(b, 1e-12)
    return out


def scheme_geomean(rows: Iterable[CellResult], num: str = "page",
                   den: str = "daemon", metric: str = "cycles") -> float:
    """Geomean of num/den over all paired cells — the paper's summary stat."""
    ratios = scheme_ratio(rows, num, den, metric)
    return geomean(ratios.values()) if ratios else float("nan")


# --------------------------------------------------------------------------
# BENCH_sim.json ledger
# --------------------------------------------------------------------------


def wall_stats(result: SweepResult) -> Dict[str, float]:
    """Non-gated throughput observability keys (``wall_*`` prefix, skipped
    by check_bench's gate): per-section wall-clock, cells/sec, and mean
    per-cell CPU seconds.  Written into every ledger entry so nightly runs
    can chart engine-throughput trends across commits."""
    n = len(result.rows)
    wall = result.wall_s
    return {
        "wall_s": round(wall, 4),
        "wall_cells_per_s": round(n / wall, 4) if wall > 0 else 0.0,
        "wall_cpu_s_per_cell": round(
            sum(r.cpu_s for r in result.rows) / n, 6) if n else 0.0,
    }


def write_bench(path: str, result: SweepResult,
                derived: Optional[Mapping[str, Any]] = None) -> dict:
    """Merge ``result`` into the BENCH_sim.json ledger at ``path`` (created if
    missing), keyed by sweep name so repeated runs overwrite their own entry.
    ``derived`` attaches summary stats (e.g. daemon-vs-page geomeans); the
    non-gated ``wall_*`` throughput keys are always attached.  The
    read-modify-write holds an advisory lock so concurrently-running
    benchmarks do not drop each other's entries."""
    lock = open(path + ".lock", "w")
    try:
        try:
            import fcntl

            fcntl.flock(lock, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: single-writer assumption
            pass
        doc: Dict[str, Any] = {"schema": BENCH_SCHEMA, "sweeps": {}}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    prev = json.load(f)
                if isinstance(prev, dict) and prev.get("schema") == BENCH_SCHEMA:
                    doc = prev
            except (json.JSONDecodeError, OSError):
                pass  # corrupt/foreign ledger: rewrite from scratch
        entry = result.as_dict()
        entry["derived"] = {**wall_stats(result), **(dict(derived or {}))}
        doc.setdefault("sweeps", {})[result.name] = entry
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return doc
    finally:
        lock.close()
