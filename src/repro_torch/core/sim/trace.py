"""Workload trace sources (DESIGN.md §2.4) behind a ``@register_workload``
registry.

A trace is three parallel numpy arrays:
    gaps:  int64 compute cycles between consecutive memory accesses
    addrs: int64 byte addresses
    writes: bool

Every source is a :class:`WorkloadSpec` carrying its own metadata — the
generator, its page compressibility (drives the link-compression model; was
the ``COMPRESSIBILITY`` side-table), and a description.  Built-ins are
synthetic generators modeled on the paper's evaluation domains (graph
processing, HPC, data analytics, bioinformatics, ML), spanning the locality
spectrum from pointer-chase (``dr``) to streaming (``st``), plus a
phase-changing source (``ph``) and ``.npz`` trace replay
(:func:`register_trace_file`; any workload name ending in ``.npz``
auto-registers as a replay of that file).  All registered names are valid
inside '+'-separated multi-CC mixes.  Define your own in ~5 lines:

    from repro_torch.core.sim import register_workload, run_one

    @register_workload("zig", compressibility=2.5,
                       description="strided zig-zag scan")
    def zigzag(seed, footprint, n):
        import numpy as np
        addrs = (np.arange(n) * 192) % footprint
        return (np.full(n, 20, np.int64), addrs.astype(np.int64),
                np.zeros(n, bool))
    run_one("zig", "daemon")

All generators are deterministic (seeded) and parameterized by footprint so
the local-memory fraction is meaningful.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

Trace = Tuple[np.ndarray, np.ndarray, np.ndarray]

DEFAULT_FOOTPRINT = 32 << 20  # 32 MiB
DEFAULT_ACCESSES = 120_000

DEFAULT_COMPRESSIBILITY = 2.0  # for direct trace injection (workload="")

# the paper's eight-workload evaluation suite, in figure order (the default
# grid of fig2/paper_claims — deliberately NOT "every registered workload",
# so registering a new source never silently changes committed grids)
DEFAULT_SUITE = ("pr", "bf", "ts", "nw", "dr", "pf", "st", "ml")


@dataclass(frozen=True)
class WorkloadSpec:
    """One registered trace source: generator + its own metadata.

    ``compressibility`` is the mean page compression ratio for the
    link-compression model (ratio ~ N(mean, 0.15*mean), >= 1): graphs/int
    data compress well; float/ML data less [paper §3(III)].  It may also
    be a zero-arg callable resolved (and cached by the callable) on first
    use — measured-from-data sources (repro_torch.capture) defer the measurement
    so registration stays import-cheap; resolve via
    :func:`compressibility_of`, never by reading the field directly.
    """

    name: str
    generator: Callable[[int, int, int], Trace]
    compressibility: object = DEFAULT_COMPRESSIBILITY  # float | () -> float
    description: str = ""

    def trace(self, *, seed: int = 0, footprint: int = DEFAULT_FOOTPRINT,
              n: int = DEFAULT_ACCESSES) -> Trace:
        return self.generator(seed, footprint, n)

    # legacy call style: WORKLOADS[name](seed, footprint, n)
    def __call__(self, seed: int, footprint: int, n: int) -> Trace:
        return self.generator(seed, footprint, n)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

# public view (name -> spec), kept under the legacy name so existing
# `tuple(WORKLOADS)` / `"pr" in WORKLOADS` call sites keep working
WORKLOADS: Dict[str, WorkloadSpec] = {}


def register_workload(name: str, *, compressibility: float = DEFAULT_COMPRESSIBILITY,
                      description: str = "", overwrite: bool = False):
    """Decorator registering ``fn(seed, footprint, n) -> Trace`` under
    ``name`` with its metadata.  Duplicate names raise unless
    ``overwrite=True``."""

    def deco(fn: Callable[[int, int, int], Trace]):
        _register(WorkloadSpec(
            name=name, generator=fn, compressibility=float(compressibility),
            description=description or (fn.__doc__ or "").strip().split("\n")[0],
        ), overwrite=overwrite)
        return fn

    return deco


def _register(spec: WorkloadSpec, *, overwrite: bool = False) -> WorkloadSpec:
    if spec.name in WORKLOADS and not overwrite:
        raise ValueError(
            f"workload {spec.name!r} already registered "
            f"(pass overwrite=True to replace)")
    if "+" in spec.name:
        raise ValueError(f"workload name {spec.name!r} may not contain '+' "
                         f"(reserved for multi-CC mixes)")
    WORKLOADS[spec.name] = spec
    return spec


def unregister_workload(name: str) -> None:
    """Remove a registered workload (tests / interactive experimentation)."""
    WORKLOADS.pop(name, None)


def get_workload(name: str) -> WorkloadSpec:
    """Resolve one workload name (NOT a '+' mix); unknown names fail fast
    listing the registered choices.  Names ending in ``.npz`` auto-register
    as trace replays of that file."""
    spec = WORKLOADS.get(name)
    if spec is None and name.endswith(".npz"):
        return register_trace_file(name)
    if spec is None:
        raise KeyError(
            f"unknown workload {name!r}; registered workloads: "
            f"{', '.join(available_workloads())} (or a path to a .npz trace)")
    return spec


def available_workloads() -> Tuple[str, ...]:
    return tuple(WORKLOADS)


def compressibility_of(name: str) -> float:
    """Per-workload mean page compression ratio; the empty name (direct
    trace injection into ``simulate``) gets the neutral default.  Callable
    (lazily measured) compressibilities are resolved here."""
    if not name:
        return DEFAULT_COMPRESSIBILITY
    c = get_workload(name).compressibility
    return float(c() if callable(c) else c)


def generate(name: str, *, seed: int = 0, footprint: int = DEFAULT_FOOTPRINT,
             n: int = DEFAULT_ACCESSES) -> Trace:
    return get_workload(name).trace(seed=seed, footprint=footprint, n=n)


# --------------------------------------------------------------------------
# .npz trace replay
# --------------------------------------------------------------------------


def replay_slice(trace: Trace, seed: int, n: int) -> Trace:
    """The replay view shared by ``.npz`` trace files and captured kernel
    workloads (repro_torch.capture): ``n`` truncates or tiles the trace and
    ``seed`` rotates the starting offset so multiple threads replay the
    same trace out of phase rather than in lockstep.  A window larger than
    the trace wraps (tiles); ``n < 1`` or an empty trace fails fast — a
    zero-length replay window is always a caller bug (e.g. a serving phase
    with no accesses), and silently returning empty arrays would shift the
    replay phase of every later slice."""
    gaps, addrs, writes = trace
    total = len(addrs)
    if n < 1 or total == 0:
        raise ValueError(
            f"replay_slice: need n >= 1 and a non-empty trace "
            f"(got n={n}, trace length {total})")
    roll = (seed * 9973) % total
    idx = (np.arange(n, dtype=np.int64) + roll) % total
    return gaps[idx], addrs[idx], writes[idx]


def save_trace(path: str, trace: Trace,
               compressibility: float = DEFAULT_COMPRESSIBILITY) -> None:
    """Persist a trace (gaps, addrs, writes) + its compressibility metadata
    as a ``.npz`` file replayable via :func:`register_trace_file` (or just by
    using the path as a workload name)."""
    gaps, addrs, writes = trace
    np.savez(path, gaps=np.asarray(gaps, np.int64),
             addrs=np.asarray(addrs, np.int64),
             writes=np.asarray(writes, bool),
             compressibility=np.float64(compressibility))


def register_trace_file(path: str, name: Optional[str] = None, *,
                        overwrite: bool = False) -> WorkloadSpec:
    """Register a ``.npz`` trace file (written by :func:`save_trace`) as a
    workload.  ``name`` defaults to the path itself, so the same string
    works as a workload name everywhere (including '+' mixes).

    Replay is deterministic: the file's footprint is authoritative (the
    ``footprint`` argument is ignored), ``n`` truncates or tiles the trace,
    and ``seed`` rotates the starting offset so multiple threads replay the
    same trace out of phase rather than in lockstep.
    """
    name = name or path
    if name in WORKLOADS:
        if overwrite:
            del WORKLOADS[name]
        else:
            return WORKLOADS[name]
    if not os.path.exists(path):
        raise FileNotFoundError(f"trace file {path!r} does not exist")
    with np.load(path) as f:
        missing = {"gaps", "addrs", "writes"} - set(f.files)
        if missing:
            raise ValueError(f"trace file {path!r} lacks arrays {sorted(missing)}")
        gaps = np.asarray(f["gaps"], np.int64)
        addrs = np.asarray(f["addrs"], np.int64)
        writes = np.asarray(f["writes"], bool)
        comp = float(f["compressibility"]) if "compressibility" in f.files \
            else DEFAULT_COMPRESSIBILITY
    if not (len(gaps) == len(addrs) == len(writes)) or len(gaps) == 0:
        raise ValueError(f"trace file {path!r}: arrays must be equal-length "
                         f"and non-empty")

    def replay(seed: int, footprint: int, n: int) -> Trace:
        return replay_slice((gaps, addrs, writes), seed, n)

    return _register(WorkloadSpec(
        name=name, generator=replay, compressibility=comp,
        description=f"replay of {path} ({len(addrs)} accesses)",
    ), overwrite=overwrite)


# --------------------------------------------------------------------------
# built-in synthetic generators
# --------------------------------------------------------------------------


def _mk(gaps, addrs, writes, footprint) -> Trace:
    return (
        np.asarray(gaps, np.int64),
        np.asarray(addrs, np.int64) % footprint,
        np.asarray(writes, bool),
    )


@register_workload("dr", compressibility=1.8)
def ptr_chase(seed: int, footprint: int, n: int) -> Trace:
    """dr (delaunay-refinement-like): random cavity walks — jump to a random
    element record, touch 3 consecutive lines, hop.  Low page locality with
    small bursts (capacity-intensive irregular, the paper's dominant class)."""
    rng = np.random.default_rng(seed)
    run = 3  # lines per visited record
    n_runs = n // run + 1
    starts = rng.integers(0, footprint, n_runs) & ~63
    offs = (np.arange(run) * 64)[None, :]
    addrs = (starts[:, None] + offs).reshape(-1)[:n]
    writes = rng.random(n) < 0.2
    gaps = rng.integers(15, 40, n)
    return _mk(gaps, addrs, writes, footprint)


@register_workload("pr", compressibility=3.0)
def pagerank(seed: int, footprint: int, n: int) -> Trace:
    """pr: irregular graph access —near-uniform random edge/vertex loads with a
    thin sequential rank stream.  LOW page locality: the paper's line-friendly
    class (moving 4 KiB to use 64 B)."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, footprint * 7 // 8, n) & ~63
    seq = (np.arange(n) * 64) % (footprint // 8) + footprint * 7 // 8
    addrs = np.where(rng.random(n) < 0.85, rand, seq)
    writes = rng.random(n) < 0.15
    gaps = rng.integers(15, 40, n)
    return _mk(gaps, addrs, writes, footprint)


@register_workload("bf", compressibility=3.0)
def bfs(seed: int, footprint: int, n: int) -> Trace:
    """bf: frontier bursts — short sequential runs at random page locations."""
    rng = np.random.default_rng(seed)
    run = 8
    n_runs = n // run
    starts = rng.integers(0, footprint, n_runs) & ~63
    offs = (np.arange(run) * 64)[None, :]
    addrs = (starts[:, None] + offs).reshape(-1)[:n]
    gaps = rng.integers(10, 30, n)
    return _mk(gaps, addrs, np.zeros(n, bool), footprint)


@register_workload("st", compressibility=4.0)
def streaming(seed: int, footprint: int, n: int) -> Trace:
    """st (data-analytics scan): fully sequential — maximal page locality."""
    rng = np.random.default_rng(seed)
    addrs = (np.arange(n) * 64) % footprint
    gaps = rng.integers(8, 20, n)
    writes = rng.random(n) < 0.1
    return _mk(gaps, addrs, writes, footprint)


@register_workload("nw", compressibility=2.5)
def nw(seed: int, footprint: int, n: int) -> Trace:
    """nw (bioinformatics DP): anti-diagonal wavefront — consecutive cells
    stride by ~a row, touching ONE line per page before moving on.  The
    paper's other line-friendly workload."""
    rng = np.random.default_rng(seed)
    row_bytes = 1 << 14  # 16 KiB rows: stride skips 4 pages per step
    i = np.arange(n, dtype=np.int64)
    addrs = (i * (row_bytes + 64)) % footprint
    writes = rng.random(n) < 0.3
    gaps = rng.integers(12, 30, n)
    return _mk(gaps, addrs, writes, footprint)


@register_workload("ts", compressibility=2.0)
def hash_join(seed: int, footprint: int, n: int) -> Trace:
    """ts (analytics): sequential probe stream + random hash-table lookups."""
    rng = np.random.default_rng(seed)
    seq = (np.arange(n) * 64) % (footprint // 2)
    ht = rng.integers(footprint // 2, footprint, n) & ~63
    addrs = np.where(np.arange(n) % 2 == 0, seq, ht)
    gaps = rng.integers(10, 25, n)
    return _mk(gaps, addrs, np.zeros(n, bool), footprint)


@register_workload("ml", compressibility=1.5)
def kmeans(seed: int, footprint: int, n: int) -> Trace:
    """ml (embedding/recsys): random embedding-row gathers (2 lines each)
    plus a thin sequential activation stream — sparse, capacity-intensive."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, footprint * 7 // 8 >> 7, n) << 7  # 128B rows
    row_burst = rows + (np.arange(n) % 2) * 64
    seq = (np.arange(n) * 64) % (footprint // 8) + footprint * 7 // 8
    addrs = np.where(rng.random(n) < 0.85, row_burst, seq)
    gaps = rng.integers(15, 35, n)
    return _mk(gaps, addrs, np.zeros(n, bool), footprint)


@register_workload("pf", compressibility=2.2)
def pf(seed: int, footprint: int, n: int) -> Trace:
    """pf (particle filter): sequential weight scan (page-friendly phase)
    interleaved with random ancestor gathers (resampling) — mixed locality."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    seq = ((i // 128) * 4096 + (i % 128) * 32) % (footprint // 2)
    rnd = (rng.integers(footprint // 2, footprint, n) & ~63)
    addrs = np.where(rng.random(n) < 0.65, seq, rnd)
    gaps = rng.integers(8, 18, n)
    writes = rng.random(n) < 0.2
    return _mk(gaps, addrs, writes, footprint)


@register_workload("wh", compressibility=3.2)
def write_heavy(seed: int, footprint: int, n: int) -> Trace:
    """wh (log-structured update): a circular read-modify-write sweep
    (~60% stores) over a working span ~5x the local page cache, so resident
    pages are re-dirtied line by line and every eviction is a writeback —
    the reverse CC->MC path carries roughly one dirty page per demand page
    (the uplink stress case, DESIGN.md §2.7).  The span scales with the
    trace length (floored at 16 pages) so the churn ratio — not the byte
    count — is what the workload pins across quick/full grid sizes."""
    rng = np.random.default_rng(seed)
    span = min(footprint, max(1024 * 64, n * 64))
    addrs = (np.arange(n, dtype=np.int64) * 64) % span
    gaps = rng.integers(8, 20, n)
    writes = rng.random(n) < 0.6
    return _mk(gaps, addrs, writes, footprint)


@register_workload("ph", compressibility=2.8)
def phased(seed: int, footprint: int, n: int) -> Trace:
    """ph: phase-changing — alternating streaming-scan and pointer-chase
    epochs (~500 accesses each), the regime where a fixed granularity is
    wrong half the time and adaptive selection has to track the phase."""
    rng = np.random.default_rng(seed)
    epoch = 500
    i = np.arange(n, dtype=np.int64)
    stream_phase = (i // epoch) % 2 == 0
    # streaming half: a sequential scan that keeps its cursor across epochs
    seq = (np.cumsum(stream_phase.astype(np.int64)) * 64) % (footprint // 2)
    # chase half: 3-line cavity walks in the upper half of the footprint
    run = 3
    starts = rng.integers(footprint // 2, footprint, n // run + 1) & ~63
    offs = (np.arange(run) * 64)[None, :]
    chase = (starts[:, None] + offs).reshape(-1)[:n]
    addrs = np.where(stream_phase, seq, chase)
    gaps = np.where(stream_phase, rng.integers(8, 20, n),
                    rng.integers(15, 40, n))
    writes = rng.random(n) < np.where(stream_phase, 0.1, 0.2)
    return _mk(gaps, addrs, writes, footprint)
