"""Public simulation API + the paper's experiment sweeps.

Every figure is one declarative :class:`~repro_torch.core.sim.sweep.Sweep` executed
by the parallel sweep engine (DESIGN.md §6); pass ``workers=N`` to fan cells
out over a process pool (results are identical to the serial run).

  run_one(workload, scheme, ...)          -> Metrics
  fig2(...)   scheme x workload grid      (paper Fig. 2)
  fig4_top(...) bw x n_mcs x workload     (paper Fig. 4 top)
  fig4_bottom(...) multi-job interference (paper Fig. 4 bottom)
  fig5_scalability(...) n_ccs x scheme x workload-mix (multi-CC contention)
  fig6_ablation(...) ablation policies x workloads (synergy decomposition)
  fig7_uplink(...) uplink_bw x write-heavy workload x n_ccs (uplink contention)
  fig8_kernels(...) captured Hopper-kernel streams x policy x bandwidth
  fig11_controllers(...) movement controller x scheme on the fig6/7/8 grids
  fig12_memside(...) placement x capacity-pressure x tenant-mix memory pool
  paper_claims(...) geomean speedups of daemon over page

Schemes and workloads are registry names (policy.py / trace.py); every
registered composition is a valid axis value.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from repro_torch.core.sim.config import SCHEMES, Metrics, SimConfig
from repro_torch.core.sim.sweep import (
    Sweep,
    SweepResult,
    geomean,
    run_one,
    run_sweep,
    scheme_ratio,
)
from repro_torch.core.sim.trace import DEFAULT_SUITE

# the paper's eight-workload suite, pinned explicitly (NOT "every registered
# workload") so registering a new source never changes the committed grids
DEFAULT_WORKLOADS = DEFAULT_SUITE


def _sweep_kw(kw: dict) -> dict:
    """Map run_one-style kwargs (seed/n_accesses/footprint) onto the
    corresponding Sweep fields; n_jobs is a per-figure axis, not mapped here."""
    out = {}
    if "n_accesses" in kw:
        out["n_accesses"] = kw.pop("n_accesses")
    if "footprint" in kw:
        out["footprint"] = kw.pop("footprint")
    if "seed" in kw:
        out["base_seed"] = kw.pop("seed")
    if kw:
        raise TypeError(f"unexpected kwargs: {sorted(kw)}")
    return out


def fig2(
    cfg: Optional[SimConfig] = None,
    workloads: Iterable[str] = DEFAULT_WORKLOADS,
    schemes: Iterable[str] = SCHEMES,
    *,
    workers: Optional[int] = None,
    n_jobs: int = 1,
    **kw,
) -> Dict[str, Dict[str, Metrics]]:
    """Slowdown grid: scheme x workload (normalize to 'local' outside)."""
    res = fig2_sweep(cfg, workloads, schemes, workers=workers, n_jobs=n_jobs, **kw)
    out: Dict[str, Dict[str, Metrics]] = {w: {} for w in res.axes["workload"]}
    for r in res.rows:
        out[r.axes["workload"]][r.axes["scheme"]] = r.metrics
    return out


def fig2_spec(
    cfg: Optional[SimConfig] = None,
    workloads: Iterable[str] = DEFAULT_WORKLOADS,
    schemes: Iterable[str] = SCHEMES,
    *,
    n_jobs: int = 1,
    **kw,
) -> Sweep:
    """The canonical Fig. 2 grid declaration (shared by the API and the
    benchmark script, so the 'fig2' BENCH_sim.json entry has one meaning)."""
    axes = {"workload": tuple(workloads), "scheme": tuple(schemes)}
    if n_jobs != 1:
        axes["n_jobs"] = (n_jobs,)
    return Sweep(name="fig2", axes=axes, base=cfg or SimConfig(), **_sweep_kw(kw))


def fig2_sweep(
    cfg: Optional[SimConfig] = None,
    workloads: Iterable[str] = DEFAULT_WORKLOADS,
    schemes: Iterable[str] = SCHEMES,
    *,
    workers: Optional[int] = None,
    n_jobs: int = 1,
    **kw,
) -> SweepResult:
    """The Fig. 2 grid as an executed SweepResult (rows carry full Metrics)."""
    return run_sweep(fig2_spec(cfg, workloads, schemes, n_jobs=n_jobs, **kw),
                     workers=workers)


def slowdowns(grid: Dict[str, Dict[str, Metrics]]) -> Dict[str, Dict[str, float]]:
    """cycles(scheme)/cycles(local) per workload."""
    out = {}
    for w, row in grid.items():
        base = row["local"].cycles
        out[w] = {s: m.cycles / base for s, m in row.items()}
    return out


def fig4_top_spec(
    workloads: Iterable[str] = ("pr", "dr", "st", "nw"),
    bw_fracs: Iterable[float] = (0.5, 0.25, 0.125),
    n_mcs_list: Iterable[int] = (1, 2, 4),
    *,
    cfg: Optional[SimConfig] = None,
    n_jobs: int = 1,
    **kw,
) -> Sweep:
    """The canonical Fig. 4 (top) grid declaration (shared by the API and
    the benchmark script, so the 'fig4_top' BENCH_sim.json entry has one
    meaning)."""
    axes = {
        "workload": tuple(workloads),
        "link_bw_frac": tuple(bw_fracs),
        "n_mcs": tuple(n_mcs_list),
        "scheme": ("page", "daemon"),
    }
    if n_jobs != 1:
        axes["n_jobs"] = (n_jobs,)
    return Sweep(name="fig4_top", axes=axes, base=cfg or SimConfig(),
                 **_sweep_kw(kw))


def fig4_top(
    workloads: Iterable[str] = ("pr", "dr", "st", "nw"),
    bw_fracs: Iterable[float] = (0.5, 0.25, 0.125),
    n_mcs_list: Iterable[int] = (1, 2, 4),
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    n_jobs: int = 1,
    **kw,
) -> List[dict]:
    """Speedup of daemon over page across network/MC configurations."""
    sw = fig4_top_spec(workloads, bw_fracs, n_mcs_list, cfg=cfg,
                       n_jobs=n_jobs, **kw)
    res = run_sweep(sw, workers=workers)
    g = res.grid("workload", "link_bw_frac", "n_mcs", "scheme")
    rows = []
    for w in sw.axes["workload"]:
        for bw in sw.axes["link_bw_frac"]:
            for n_mcs in sw.axes["n_mcs"]:
                mp = g[(w, bw, n_mcs, "page")].metrics
                md = g[(w, bw, n_mcs, "daemon")].metrics
                rows.append(
                    {
                        "workload": w,
                        "bw_frac": bw,
                        "n_mcs": n_mcs,
                        "speedup": mp.cycles / md.cycles,
                        "access_cost_ratio": mp.avg_access_cost / max(md.avg_access_cost, 1e-9),
                        "net_bytes_ratio": mp.net_bytes / max(md.net_bytes, 1e-9),
                    }
                )
    return rows


def fig4_bottom_spec(
    workloads: Iterable[str] = ("pr", "dr", "st", "nw"),
    n_jobs: int = 4,
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """The canonical Fig. 4 (bottom) grid declaration."""
    return Sweep(
        name="fig4_bottom",
        axes={"workload": tuple(workloads), "scheme": ("page", "daemon"),
              "n_jobs": (n_jobs,)},
        base=cfg or SimConfig(),
        **_sweep_kw(kw),
    )


def fig4_bottom(
    workloads: Iterable[str] = ("pr", "dr", "st", "nw"),
    n_jobs: int = 4,
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    **kw,
) -> List[dict]:
    """Multiple concurrent jobs on one CC sharing the network and one MC."""
    sw = fig4_bottom_spec(workloads, n_jobs, cfg=cfg, **kw)
    res = run_sweep(sw, workers=workers)
    g = res.grid("workload", "scheme")
    rows = []
    for w in sw.axes["workload"]:
        mp, md = g[(w, "page")].metrics, g[(w, "daemon")].metrics
        rows.append(
            {
                "workload": w,
                "n_jobs": n_jobs,
                "speedup": mp.cycles / md.cycles,
                "access_cost_ratio": mp.avg_access_cost / max(md.avg_access_cost, 1e-9),
            }
        )
    return rows


DEFAULT_CC_MIXES = ("pr", "pr+st", "dr+st+pr+ml")


def fig5_scalability_spec(
    workload_mixes: Iterable[str] = DEFAULT_CC_MIXES,
    n_ccs_list: Iterable[int] = (1, 2, 4, 8),
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """The canonical multi-CC scalability grid (DESIGN.md §2.5): n_ccs
    compute complexes, each running a full application (a '+'-mix assigns
    workloads round-robin across CCs), contending for the shared MC
    downlink.  Shared by the API and benchmarks/fig5_scalability.py so the
    'fig5_scalability' BENCH_sim.json entry has one meaning."""
    axes = {
        "workload": tuple(workload_mixes),
        "n_ccs": tuple(n_ccs_list),
        "scheme": ("page", "daemon"),
    }
    return Sweep(name="fig5_scalability", axes=axes,
                 base=cfg or SimConfig(link_bw_frac=0.25), **_sweep_kw(kw))


def fig5_scalability(
    workload_mixes: Iterable[str] = DEFAULT_CC_MIXES,
    n_ccs_list: Iterable[int] = (1, 2, 4, 8),
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    **kw,
) -> List[dict]:
    """Daemon-vs-page speedup as a function of CC count: per (mix, n_ccs)
    rows plus the per-n_ccs geomean over the mixes."""
    sw = fig5_scalability_spec(workload_mixes, n_ccs_list, cfg=cfg, **kw)
    res = run_sweep(sw, workers=workers)
    g = res.grid("workload", "n_ccs", "scheme")
    rows = []
    for n_ccs in sw.axes["n_ccs"]:
        ratios = []
        for mix in sw.axes["workload"]:
            mp = g[(mix, n_ccs, "page")].metrics
            md = g[(mix, n_ccs, "daemon")].metrics
            ratios.append(mp.cycles / md.cycles)
            rows.append(
                {
                    "workload": mix,
                    "n_ccs": n_ccs,
                    "speedup": mp.cycles / md.cycles,
                    "access_cost_ratio": mp.avg_access_cost / max(md.avg_access_cost, 1e-9),
                    "net_bytes_ratio": mp.net_bytes / max(md.net_bytes, 1e-9),
                }
            )
        rows.append({"workload": "geomean", "n_ccs": n_ccs,
                     "speedup": geomean(ratios)})
    return rows


# the fig6 ablation grid: 'page' is the baseline, 'daemon' the full
# synergy; three ablations remove exactly one technique each (daemon_fifo:
# partitioning, daemon_fixed_gran: adaptive selection, daemon_nocomp:
# compression) and both_dualq keeps ONLY decoupled movement + partitioning
# (no selection unit, no throttle, no compression) — see policy.py
ABLATION_POLICIES = ("both_dualq", "daemon_fifo", "daemon_fixed_gran",
                     "daemon_nocomp")
# the paper suite plus the phase-changing source (where fixed granularity
# is wrong half the time — the adaptive-selection ablation's stress case)
ABLATION_WORKLOADS = DEFAULT_SUITE + ("ph",)


def fig6_ablation_spec(
    workloads: Iterable[str] = ABLATION_WORKLOADS,
    policies: Iterable[str] = ("page",) + ABLATION_POLICIES + ("daemon",),
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """The canonical ablation grid (DESIGN.md §2.6): policy x workload at
    the congested end of the paper's network range, where every technique's
    contribution is visible.  Shared by the API and
    benchmarks/fig6_ablation.py so the 'fig6_ablation' BENCH_sim.json entry
    has one meaning."""
    axes = {"workload": tuple(workloads), "scheme": tuple(policies)}
    return Sweep(name="fig6_ablation", axes=axes,
                 base=cfg or SimConfig(link_bw_frac=0.125), **_sweep_kw(kw))


def fig6_geomeans(res: SweepResult) -> List[dict]:
    """Per-policy speedups over 'page' from an executed fig6 grid: one row
    per non-baseline policy with the geomean across the grid's workloads
    plus the per-workload ratios.  The single source of the fig6 derived
    numbers — shared by :func:`fig6_ablation` and
    benchmarks/fig6_ablation.py so the CI-gated ledger values and the
    public API cannot diverge."""
    g = res.grid("workload", "scheme")
    rows = []
    for p in res.axes["scheme"]:
        if p == "page":
            continue
        ratios = {
            w: g[(w, "page")].metrics.cycles / g[(w, p)].metrics.cycles
            for w in res.axes["workload"]
        }
        rows.append({"policy": p, "geomean_vs_page": geomean(ratios.values()),
                     "per_workload": ratios})
    return rows


def fig6_ablation(
    workloads: Iterable[str] = ABLATION_WORKLOADS,
    policies: Iterable[str] = ("page",) + ABLATION_POLICIES + ("daemon",),
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    **kw,
) -> List[dict]:
    """The paper's ablation study: each technique contributes, the synergy
    dominates.  Per-policy rows carry the geomean speedup over 'page' across
    the workloads (plus per-workload ratios); every ablation should land
    strictly between 'page' (1.0) and 'daemon'."""
    sw = fig6_ablation_spec(workloads, policies, cfg=cfg, **kw)
    return fig6_geomeans(run_sweep(sw, workers=workers))


# the fig7 uplink grid (DESIGN.md §2.7): write-heavy workloads — sources
# whose migrated pages go back dirty, so the CC->MC reverse path actually
# carries writeback bulk ('wh' is the dedicated stress source)
UPLINK_WORKLOADS = ("wh", "st", "pf")
# uplink capacity as a fraction of the downlink: 1.0 = symmetric,
# 0.25 = the strongly-asymmetric fabrics the sweep is about
UPLINK_FRACS = (0.25, 0.5, 1.0)


def fig7_uplink_spec(
    workloads: Iterable[str] = UPLINK_WORKLOADS,
    uplink_fracs: Iterable[float] = UPLINK_FRACS,
    n_ccs_list: Iterable[int] = (1, 4),
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """The canonical uplink-contention grid (DESIGN.md §2.7): uplink/downlink
    asymmetry x write-heavy workload x CC count, page vs daemon.  The
    ``uplink_bw`` axis is absolute bytes/cycle derived from ``uplink_fracs``
    x the base config's ``link_bw``.  Shared by the API and
    benchmarks/fig7_uplink.py so the 'fig7_uplink' BENCH_sim.json entry has
    one meaning."""
    base = cfg or SimConfig()
    axes = {
        "workload": tuple(workloads),
        "uplink_bw": tuple(base.link_bw * f for f in uplink_fracs),
        "n_ccs": tuple(n_ccs_list),
        "scheme": ("page", "daemon"),
    }
    return Sweep(name="fig7_uplink", axes=axes, base=base, **_sweep_kw(kw))


def fig7_uplink(
    workloads: Iterable[str] = UPLINK_WORKLOADS,
    uplink_fracs: Iterable[float] = UPLINK_FRACS,
    n_ccs_list: Iterable[int] = (1, 4),
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    **kw,
) -> List[dict]:
    """Daemon-vs-page speedup as the uplink tightens: per (workload, n_ccs,
    uplink_bw) rows plus the per-uplink_bw geomean.  The paper's
    bandwidth-partitioning argument extended to the reverse path: under a
    FIFO uplink the page scheme's request packets queue behind 4 KiB
    writebacks, so daemon's advantage grows as ``uplink_bw`` drops."""
    sw = fig7_uplink_spec(workloads, uplink_fracs, n_ccs_list, cfg=cfg, **kw)
    res = run_sweep(sw, workers=workers)
    g = res.grid("workload", "uplink_bw", "n_ccs", "scheme")
    rows = []
    for ub in sw.axes["uplink_bw"]:
        ratios = []
        for w in sw.axes["workload"]:
            for n_ccs in sw.axes["n_ccs"]:
                mp = g[(w, ub, n_ccs, "page")].metrics
                md = g[(w, ub, n_ccs, "daemon")].metrics
                ratios.append(mp.cycles / md.cycles)
                rows.append(
                    {
                        "workload": w,
                        "uplink_bw": ub,
                        "n_ccs": n_ccs,
                        "speedup": mp.cycles / md.cycles,
                        "wb_page": mp.writebacks,
                        "uplink_bytes_ratio":
                            mp.uplink_bytes / max(md.uplink_bytes, 1e-9),
                    }
                )
        rows.append({"workload": "geomean", "uplink_bw": ub,
                     "speedup": geomean(ratios)})
    return rows


# the fig8 captured-kernel grid (DESIGN.md §2.8): the four Hopper-kernel
# streams captured by repro_torch.capture, registered at import (port seam
# (b); the original grid runs its Pallas captures)
KERNEL_WORKLOADS = ("fa_prefill_h100", "fa_decode_h100", "mamba_fwd_h100",
                    "bq_quant_h100")
# page vs daemon plus the granularity extremes: pure line movement and
# daemon minus the selection unit (fixed granularity) — the ablations that
# show WHERE adaptive selection matters on real tiled streams
KERNEL_SCHEMES = ("page", "cacheline", "daemon_fixed_gran", "daemon")
KERNEL_BW_FRACS = (0.125, 0.5, 1.0)


def fig8_kernels_spec(
    workloads: Iterable[str] = KERNEL_WORKLOADS,
    schemes: Iterable[str] = KERNEL_SCHEMES,
    bw_fracs: Iterable[float] = KERNEL_BW_FRACS,
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """The canonical captured-kernel grid (DESIGN.md §2.8): captured Hopper
    workloads x movement policy x network bandwidth.  Shared by the API and
    benchmarks/fig8_kernels.py so the 'fig8_kernels' BENCH_sim.json entry
    has one meaning."""
    axes = {
        "workload": tuple(workloads),
        "link_bw_frac": tuple(bw_fracs),
        "scheme": tuple(schemes),
    }
    return Sweep(name="fig8_kernels", axes=axes, base=cfg or SimConfig(),
                 **_sweep_kw(kw))


def fig8_kernels(
    workloads: Iterable[str] = KERNEL_WORKLOADS,
    schemes: Iterable[str] = KERNEL_SCHEMES,
    bw_fracs: Iterable[float] = KERNEL_BW_FRACS,
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    **kw,
) -> List[dict]:
    """Movement policies on the kernels' own memory streams: per captured
    workload, the daemon-vs-page geomean across the bandwidth range plus
    per-(bw, scheme) speedups over page.  Real tiled streams (dense spatial
    reuse inside a tile, abrupt inter-tile jumps) are page-friendly in a way
    no synthetic source in the suite is, so daemon's selection unit should
    converge to page granularity on them where pure line movement loses;
    PERF.md records the grid on the Hopper streams."""
    sw = fig8_kernels_spec(workloads, schemes, bw_fracs, cfg=cfg, **kw)
    res = run_sweep(sw, workers=workers)
    g = res.grid("workload", "link_bw_frac", "scheme")
    rows = []
    for w in sw.axes["workload"]:
        ratios = []
        for bw in sw.axes["link_bw_frac"]:
            mp = g[(w, bw, "page")].metrics
            ratios.append(mp.cycles / g[(w, bw, "daemon")].metrics.cycles)
            for s in sw.axes["scheme"]:
                if s == "page":
                    continue
                ms = g[(w, bw, s)].metrics
                rows.append(
                    {
                        "workload": w,
                        "bw_frac": bw,
                        "scheme": s,
                        "speedup_vs_page": mp.cycles / ms.cycles,
                        "net_bytes_ratio": mp.net_bytes / max(ms.net_bytes, 1e-9),
                    }
                )
        rows.append({"workload": w, "scheme": "daemon",
                     "bw_frac": "geomean", "speedup_vs_page": geomean(ratios)})
    return rows


# the fig9 serving grid (DESIGN.md §2.9): request-level tail latency under
# open-loop load.  Two tenant profiles share the sweep machinery:
#   llm   — prefill = one fa_prefill_h100 burst, decode = fa_decode_h100
#           slices (the captured Hopper streams, port seam (b); page-dense,
#           so page granularity serves tails well and daemon correctly
#           converges to ~1x)
#   graph — a graph-analytics tenant issuing query requests (the paper's
#           'pr' source as both phases; sparse irregular gathers, where
#           page-granularity tails collapse under load and daemon's
#           adaptive movement wins p99 by >10x)
# The pair is the request-level restatement of the paper's robustness
# claim "across application characteristics".
SERVING_TENANTS = {
    "llm": ("fa_prefill_h100", "fa_decode_h100"),
    "graph": ("pr", "pr"),
}
SERVING_LOADS = (8.0, 16.0, 24.0)  # offered load, requests per Mcycle
SERVING_ROUTERS = ("round_robin", "least_loaded", "disagg_prefill")


def fig9_serving_spec(
    loads: Iterable[float] = SERVING_LOADS,
    routers: Iterable[str] = SERVING_ROUTERS,
    schemes: Iterable[str] = ("page", "daemon"),
    *,
    tenant: str = "llm",
    cfg: Optional[SimConfig] = None,
    n_requests: int = 48,
    prefill_accesses: int = 1024,
    decode_steps: int = 4,
    decode_accesses: int = 256,
    **kw,
) -> Sweep:
    """The canonical serving grid (DESIGN.md §2.9) for one tenant profile:
    offered load x router policy x scheme, on a 4-CC node with a congested
    downlink (1/8 bus bandwidth) and an asymmetric contended uplink.  The
    sweep name is ``fig9_serving_<tenant>``; shared by the API and
    benchmarks/fig9_serving.py so each BENCH_sim.json entry has one
    meaning."""
    if tenant not in SERVING_TENANTS:
        raise KeyError(f"unknown serving tenant {tenant!r}; "
                       f"choose from {sorted(SERVING_TENANTS)}")
    pre, dec = SERVING_TENANTS[tenant]
    base = cfg or SimConfig(n_ccs=4, link_bw_frac=0.125, uplink_bw=1.0)
    base = base.with_(
        prefill_workload=pre, decode_workload=dec, n_requests=n_requests,
        prefill_accesses=prefill_accesses, decode_steps=decode_steps,
        decode_accesses=decode_accesses)
    axes = {
        "offered_load": tuple(loads),
        "serving_router": tuple(routers),
        "scheme": tuple(schemes),
    }
    return Sweep(name=f"fig9_serving_{tenant}", axes=axes, base=base,
                 **_sweep_kw(kw))


def fig9_tails(res: SweepResult, tenant: str) -> tuple:
    """Derived tail statistics from an executed fig9 grid: per (load,
    router) rows with p50/p99/goodput for page and daemon, a per-load
    geomean row, and the gated derived keys
    ``daemon_vs_page_p99@load=<L>:tenant=<T>`` (geomean over routers of
    page_p99/daemon_p99 — >1 means daemon serves the tail better).  The
    single source of the fig9 derived numbers — shared by
    :func:`fig9_serving` and benchmarks/fig9_serving.py so the CI-gated
    ledger values and the public API cannot diverge."""
    g = res.grid("offered_load", "serving_router", "scheme")
    rows: List[dict] = []
    derived: Dict[str, float] = {}
    for load in res.axes["offered_load"]:
        ratios = []
        for router in res.axes["serving_router"]:
            mp = g[(load, router, "page")].metrics
            md = g[(load, router, "daemon")].metrics
            ratio = mp.request_p99 / max(md.request_p99, 1e-9)
            ratios.append(ratio)
            rows.append(
                {
                    "tenant": tenant,
                    "offered_load": load,
                    "router": router,
                    "p99_ratio": ratio,
                    "page_p99": mp.request_p99,
                    "daemon_p99": md.request_p99,
                    "page_p50": mp.request_p50,
                    "daemon_p50": md.request_p50,
                    "page_goodput": mp.goodput,
                    "daemon_goodput": md.goodput,
                    "completed": (mp.requests_completed,
                                  md.requests_completed),
                }
            )
        gm = geomean(ratios)
        derived[f"daemon_vs_page_p99@load={load:g}:tenant={tenant}"] = gm
        rows.append({"tenant": tenant, "offered_load": load,
                     "router": "geomean", "p99_ratio": gm})
    return rows, derived


def fig9_serving(
    loads: Iterable[float] = SERVING_LOADS,
    routers: Iterable[str] = SERVING_ROUTERS,
    schemes: Iterable[str] = ("page", "daemon"),
    *,
    tenants: Iterable[str] = ("llm", "graph"),
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    n_requests: int = 48,
    prefill_accesses: int = 1024,
    decode_steps: int = 4,
    decode_accesses: int = 256,
    **kw,
) -> List[dict]:
    """Request tail latency under open-loop load: one sweep per tenant
    profile, rows per (tenant, load, router) with page/daemon p50/p99/
    goodput plus per-load p99-ratio geomeans.  The headline mirrors fig8's
    at the request level: on the captured LLM kernel streams page
    granularity already serves tails well (ratios ~1x), while the sparse
    graph tenant's p99 collapses under page-granularity movement and
    daemon wins the tail by an order of magnitude."""
    rows: List[dict] = []
    for tenant in tenants:
        sw = fig9_serving_spec(
            loads, routers, schemes, tenant=tenant, cfg=cfg,
            n_requests=n_requests, prefill_accesses=prefill_accesses,
            decode_steps=decode_steps, decode_accesses=decode_accesses,
            **dict(kw))
        t_rows, _ = fig9_tails(run_sweep(sw, workers=workers), tenant)
        rows += t_rows
    return rows


# the fig10 topology grid (DESIGN.md §2.11): routed fabrics between the
# compute and memory pools.  'direct' is the legacy flat per-MC link bundle
# expressed as a 1-hop fabric (bit-identical metrics); 'single_switch' folds
# every flow through one crossbar; 'two_tier' adds leaf/spine trunks whose
# capacity shrinks with the oversubscription ratio
TOPOLOGIES = ("direct", "single_switch", "two_tier")
# pointer-chase (latency-bound lines) vs streaming (page-friendly bulk):
# the pair where fabric partitioning matters most and least
TOPOLOGY_WORKLOADS = ("pr", "st")
# trunk oversubscription ratios for the two_tier grid: 1.0 = non-blocking
OVERSUBS = (1.0, 2.0, 4.0)


def fig10_topology_spec(
    topologies: Iterable[str] = TOPOLOGIES,
    workloads: Iterable[str] = TOPOLOGY_WORKLOADS,
    n_ccs_list: Iterable[int] = (1, 4),
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """The canonical topology grid (DESIGN.md §2.11): fabric shape x
    workload x CC count, page vs daemon, at the congested end of the
    paper's network range.  Shared by the API and
    benchmarks/fig10_topology.py so the 'fig10_topology' BENCH_sim.json
    entry has one meaning."""
    axes = {
        "workload": tuple(workloads),
        "topology": tuple(topologies),
        "n_ccs": tuple(n_ccs_list),
        "scheme": ("page", "daemon"),
    }
    return Sweep(name="fig10_topology", axes=axes,
                 base=cfg or SimConfig(link_bw_frac=0.25), **_sweep_kw(kw))


def fig10_oversub_spec(
    oversubs: Iterable[float] = OVERSUBS,
    workloads: Iterable[str] = TOPOLOGY_WORKLOADS,
    n_ccs_list: Iterable[int] = (1, 4),
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """The canonical oversubscription grid (DESIGN.md §2.11): the two_tier
    fabric's leaf/spine trunks tightened from non-blocking (1.0) to 4:1,
    page vs daemon.  Daemon's dual-queue partitioning rides every hop, so
    its advantage must grow monotonically as the trunks congest — the
    fabric-level restatement of the paper's Fig. 4 bandwidth sweep."""
    base = (cfg or SimConfig(link_bw_frac=0.25)).with_(topology="two_tier")
    axes = {
        "workload": tuple(workloads),
        "oversub": tuple(oversubs),
        "n_ccs": tuple(n_ccs_list),
        "scheme": ("page", "daemon"),
    }
    return Sweep(name="fig10_oversub", axes=axes, base=base, **_sweep_kw(kw))


def fig10_topology(
    topologies: Iterable[str] = TOPOLOGIES,
    oversubs: Iterable[float] = OVERSUBS,
    workloads: Iterable[str] = TOPOLOGY_WORKLOADS,
    n_ccs_list: Iterable[int] = (1, 4),
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    **kw,
) -> List[dict]:
    """Daemon-vs-page speedup across fabric shapes and trunk
    oversubscription: per-cell rows plus a per-topology geomean and a
    per-oversub geomean (two_tier).  The headline: page's 4 KiB transfers
    monopolise every shared trunk they cross, so the deeper and more
    oversubscribed the fabric, the more daemon's end-to-end dual-queue
    partitioning is worth."""
    rows: List[dict] = []
    sw = fig10_topology_spec(topologies, workloads, n_ccs_list, cfg=cfg,
                             **dict(kw))
    g = run_sweep(sw, workers=workers).grid(
        "workload", "topology", "n_ccs", "scheme")
    for topo in sw.axes["topology"]:
        ratios = []
        for w in sw.axes["workload"]:
            for n_ccs in sw.axes["n_ccs"]:
                mp = g[(w, topo, n_ccs, "page")].metrics
                md = g[(w, topo, n_ccs, "daemon")].metrics
                ratios.append(mp.cycles / md.cycles)
                rows.append(
                    {
                        "workload": w,
                        "topology": topo,
                        "n_ccs": n_ccs,
                        "speedup": mp.cycles / md.cycles,
                        "net_bytes_ratio": mp.net_bytes / max(md.net_bytes, 1e-9),
                    }
                )
        rows.append({"workload": "geomean", "topology": topo,
                     "speedup": geomean(ratios)})
    so = fig10_oversub_spec(oversubs, workloads, n_ccs_list, cfg=cfg,
                            **dict(kw))
    go = run_sweep(so, workers=workers).grid(
        "workload", "oversub", "n_ccs", "scheme")
    for o in so.axes["oversub"]:
        ratios = []
        for w in so.axes["workload"]:
            for n_ccs in so.axes["n_ccs"]:
                mp = go[(w, o, n_ccs, "page")].metrics
                md = go[(w, o, n_ccs, "daemon")].metrics
                ratios.append(mp.cycles / md.cycles)
                rows.append(
                    {
                        "workload": w,
                        "topology": "two_tier",
                        "oversub": o,
                        "n_ccs": n_ccs,
                        "speedup": mp.cycles / md.cycles,
                    }
                )
        rows.append({"workload": "geomean", "topology": "two_tier",
                     "oversub": o, "speedup": geomean(ratios)})
    return rows


# the fig11 controller grids (DESIGN.md §2.12): the registered movement
# controllers compared head-to-head on the three grids where the selection
# unit's decisions bind — the synthetic ablation suite, the asymmetric
# uplink grid, and the captured Hopper-kernel streams
CONTROLLERS = ("fixed", "adaptive", "tuned")
# fig11 compares the controllers inside the daemon scheme against the page
# baseline; the ablation policies are fig6's concern, not fig11's
CONTROLLER_SCHEMES = ("page", "daemon")


def fig11_ablation_spec(
    workloads: Iterable[str] = ABLATION_WORKLOADS,
    controllers: Iterable[str] = CONTROLLERS,
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """Controller x workload on fig6's congested synthetic grid (DESIGN.md
    §2.12): the guardrail half of fig11 — a controller that loses to
    'fixed' here trades away the paper's headline speedups.  Shared by the
    API and benchmarks/fig11_controllers.py so the
    'daemon_vs_page_geomean@ctrl=*' BENCH_sim.json entries have one
    meaning."""
    axes = {
        "workload": tuple(workloads),
        "controller": tuple(controllers),
        "scheme": CONTROLLER_SCHEMES,
    }
    return Sweep(name="fig11_ablation", axes=axes,
                 base=cfg or SimConfig(link_bw_frac=0.125), **_sweep_kw(kw))


def fig11_uplink_spec(
    workloads: Iterable[str] = UPLINK_WORKLOADS,
    uplink_fracs: Iterable[float] = UPLINK_FRACS,
    controllers: Iterable[str] = CONTROLLERS,
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """Controller x uplink asymmetry on fig7's write-heavy grid: where the
    adaptive controller's uplink-backlog signal (compress writebacks before
    the reverse path saturates) can actually pay."""
    base = cfg or SimConfig()
    axes = {
        "workload": tuple(workloads),
        "uplink_bw": tuple(base.link_bw * f for f in uplink_fracs),
        "controller": tuple(controllers),
        "scheme": CONTROLLER_SCHEMES,
    }
    return Sweep(name="fig11_uplink", axes=axes, base=base, **_sweep_kw(kw))


def fig11_kernels_spec(
    workloads: Iterable[str] = KERNEL_WORKLOADS,
    bw_fracs: Iterable[float] = KERNEL_BW_FRACS,
    controllers: Iterable[str] = CONTROLLERS,
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """Controller x bandwidth on fig8's captured Hopper-kernel streams: the
    upside half of fig11 — the page-dense phases where 'fixed' keeps racing
    lines it always loses and an observing controller can back off."""
    axes = {
        "workload": tuple(workloads),
        "link_bw_frac": tuple(bw_fracs),
        "controller": tuple(controllers),
        "scheme": CONTROLLER_SCHEMES,
    }
    return Sweep(name="fig11_kernels", axes=axes, base=cfg or SimConfig(),
                 **_sweep_kw(kw))


def fig11_geomeans(
    ab: SweepResult, up: SweepResult, kn: SweepResult,
) -> Dict[str, float]:
    """Derived daemon-vs-page geomeans per controller from executed fig11
    grids — the single source of the 'daemon_vs_page_geomean@ctrl=*' ledger
    keys (gated by benchmarks/check_bench.py), shared by
    :func:`fig11_controllers` and benchmarks/fig11_controllers.py.

    Per controller ``c``: ``@ctrl={c}`` (synthetic ablation suite),
    ``@ctrl={c}:grid=uplink`` (write-heavy uplink grid), and one
    ``@ctrl={c}:kernel={w}`` per captured kernel (geomean across the
    bandwidth range).  'fixed' rows must reproduce the controller-free
    grids bit-for-bit; 'adaptive' must clear the fixed kernel baselines on
    at least one captured stream without giving back the synthetics."""
    out: Dict[str, float] = {}
    ga = ab.grid("workload", "controller", "scheme")
    gu = up.grid("workload", "uplink_bw", "controller", "scheme")
    gk = kn.grid("workload", "link_bw_frac", "controller", "scheme")
    for c in ab.axes["controller"]:
        out[f"daemon_vs_page_geomean@ctrl={c}"] = geomean(
            ga[(w, c, "page")].metrics.cycles
            / ga[(w, c, "daemon")].metrics.cycles
            for w in ab.axes["workload"])
        out[f"daemon_vs_page_geomean@ctrl={c}:grid=uplink"] = geomean(
            gu[(w, ub, c, "page")].metrics.cycles
            / gu[(w, ub, c, "daemon")].metrics.cycles
            for w in up.axes["workload"] for ub in up.axes["uplink_bw"])
        for w in kn.axes["workload"]:
            out[f"daemon_vs_page_geomean@ctrl={c}:kernel={w}"] = geomean(
                gk[(w, bw, c, "page")].metrics.cycles
                / gk[(w, bw, c, "daemon")].metrics.cycles
                for bw in kn.axes["link_bw_frac"])
    return out


def fig11_controllers(
    controllers: Iterable[str] = CONTROLLERS,
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    **kw,
) -> Dict[str, float]:
    """Head-to-head movement controllers (DESIGN.md §2.12): daemon-vs-page
    geomeans per controller over the synthetic ablation suite, the
    asymmetric-uplink grid, and the captured kernel streams.  The headline:
    'fixed' reproduces every legacy number exactly, 'adaptive' buys back
    the kernel traces (where fixed granularity racing loses) at <5% cost on
    the synthetics, 'tuned' shows the offline-fitted ceiling."""
    kw2 = dict(kw)
    ab = run_sweep(fig11_ablation_spec(controllers=controllers, cfg=cfg,
                                       **dict(kw2)), workers=workers)
    up = run_sweep(fig11_uplink_spec(controllers=controllers, cfg=cfg,
                                     **dict(kw2)), workers=workers)
    kn = run_sweep(fig11_kernels_spec(controllers=controllers, cfg=cfg,
                                      **dict(kw2)), workers=workers)
    return fig11_geomeans(ab, up, kn)


# the fig12 memory-pool grids (DESIGN.md §2.13): finite per-MC capacity and
# first-class placement policies under multi-tenant '+'-mixes — the scenario
# family the paper never swept (it models remote memory as an infinite
# passive address space)
MEM_PLACEMENTS = ("page", "first_touch", "capacity_aware")
# pages per MC: None = legacy infinite pool (the bit-identical baseline),
# 512 = mild pressure (spills begin), 128 = heavy churn (eviction-dominated)
MEM_CAPACITIES = (None, 512, 128)
# fig12 compares daemon against the page baseline under capacity pressure;
# the controller comparison is fig11's concern
MEM_SCHEMES = ("page", "daemon")


def _mem_tag(cap: Optional[int]) -> str:
    return "inf" if cap is None else str(cap)


def fig12_memside_spec(
    workload_mixes: Iterable[str] = DEFAULT_CC_MIXES,
    placements: Iterable[str] = MEM_PLACEMENTS,
    capacities: Iterable[Optional[int]] = MEM_CAPACITIES,
    *,
    cfg: Optional[SimConfig] = None,
    **kw,
) -> Sweep:
    """Tenant mix x placement x capacity pressure x scheme (DESIGN.md
    §2.13): four CCs run skewed '+'-mixes against four finite MCs, so
    placement decides which modules fill, spills detour across the ring,
    and cold residents churn out under pressure.  Shared by the API and
    benchmarks/fig12_memside.py so the 'daemon_vs_page_geomean@mem=*'
    BENCH_sim.json entries have one meaning.  Every cell is batch-engine
    covered (§2.13 cells run on the lockstep core)."""
    axes = {
        "workload": tuple(workload_mixes),
        "mc_interleave": tuple(placements),
        "mc_capacity_pages": tuple(capacities),
        "scheme": MEM_SCHEMES,
    }
    base = cfg or SimConfig(n_ccs=4, n_mcs=4, link_bw_frac=0.25)
    return Sweep(name="fig12_memside", axes=axes, base=base, **_sweep_kw(kw))


def fig12_geomeans(res: SweepResult) -> Dict[str, float]:
    """Derived daemon-vs-page geomeans per (capacity, placement) cell of an
    executed fig12 grid — the single source of the
    'daemon_vs_page_geomean@mem={inf|<cap>}:place=<p>' ledger keys (gated
    by benchmarks/check_bench.py).  The headline question: does DaeMon's
    decoupled-granularity advantage survive when page migration also
    triggers capacity evictions?  '@mem=inf' rows must reproduce the
    infinite-pool behaviour of the legacy grids."""
    out: Dict[str, float] = {}
    g = res.grid("workload", "mc_interleave", "mc_capacity_pages", "scheme")
    for cap in res.axes["mc_capacity_pages"]:
        for pl in res.axes["mc_interleave"]:
            out[f"daemon_vs_page_geomean@mem={_mem_tag(cap)}:place={pl}"] = \
                geomean(
                    g[(w, pl, cap, "page")].metrics.cycles
                    / g[(w, pl, cap, "daemon")].metrics.cycles
                    for w in res.axes["workload"])
    return out


def fig12_memside(
    *,
    cfg: Optional[SimConfig] = None,
    workers: Optional[int] = None,
    engine: Optional[str] = None,
    **kw,
) -> Dict[str, float]:
    """Memory-pool grid (DESIGN.md §2.13): daemon-vs-page geomeans per
    (capacity pressure, placement policy) over the multi-tenant mixes."""
    res = run_sweep(fig12_memside_spec(cfg=cfg, **kw), workers=workers,
                    engine=engine)
    return fig12_geomeans(res)


def paper_claims(
    bw_fracs: Iterable[float] = (0.25, 0.125),
    *,
    workloads: Iterable[str] = DEFAULT_WORKLOADS,
    workers: Optional[int] = None,
    n_jobs: int = 1,
    **kw,
) -> dict:
    """Geomean daemon-vs-page improvements over the workload suite across the
    paper's network operating range — the quantities the paper reports as
    3.06x (access-cost reduction) and 2.39x (performance)."""
    axes = {
        "link_bw_frac": tuple(bw_fracs),
        "workload": tuple(workloads),
        "scheme": ("page", "daemon"),
    }
    if n_jobs != 1:
        axes["n_jobs"] = (n_jobs,)
    sw = Sweep(name="paper_claims", axes=axes, **_sweep_kw(kw))
    res = run_sweep(sw, workers=workers)
    perf, cost, per_bw = [], [], {}
    for bw in sw.axes["link_bw_frac"]:
        rows = res.filter(link_bw_frac=bw)
        p = scheme_ratio(rows, metric="cycles")
        c = scheme_ratio(rows, metric="avg_access_cost")
        per_bw[bw] = {
            "perf": geomean(p.values()),
            "cost": geomean(c.values()),
            "per_workload": {
                dict(k)["workload"]: v for k, v in p.items()
            },
        }
        perf += list(p.values())
        cost += list(c.values())
    return {
        "perf_speedup_geomean": geomean(perf),
        "access_cost_reduction_geomean": geomean(cost),
        "per_bw": per_bw,
    }
