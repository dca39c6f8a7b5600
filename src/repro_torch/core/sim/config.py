"""Simulator configuration for the disaggregated-system model (§2.1 of
DESIGN.md).  Units: CPU cycles (3 GHz nominal).  Defaults follow the paper's
evaluation: local memory fits ~20% of the application footprint, network
bandwidth is 1/2..1/8 of the memory bus bandwidth [Gao et al., OSDI'16], and
page movements may be link-compressed.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.core.sim.controller import available_controllers
from repro_torch.core.sim.fabric import available_topologies
from repro_torch.core.sim.memside import available_placements

# The paper's six schemes, in figure order.  Since the policy registry
# (policy.py) these are just the six legacy *registered compositions*;
# `available_policies()` lists every registered policy including ablations.
SCHEMES = ("local", "page", "page_free", "cacheline", "both", "daemon")

# the legacy static placements (memside.LEGACY_PLACEMENTS): kept for
# back-compat — mc_interleave now validates against the full placement
# registry (memside.available_placements), of which these are the subset
# that keeps the engines on the infinite-memory fast path
MC_INTERLEAVES = ("page", "hash", "single")


@dataclass(frozen=True)
class SimConfig:
    # geometry
    line_bytes: int = 64
    page_bytes: int = 4096
    header_bytes: int = 16  # per network packet

    # CCs (§2.5 of DESIGN.md): n_ccs independent compute complexes, each with
    # its own cores/LLC/local page cache (and, for daemon, its own engines),
    # all contending for the SAME per-MC downlinks.  n_ccs=1 is the legacy
    # single-CC model, bit-for-bit.
    n_ccs: int = 1
    llc_bytes: int = 1 << 21  # 2 MiB LLC
    llc_assoc: int = 16
    llc_lat: int = 30
    local_mem_frac: float = 0.2  # local memory fits ~20% of footprint
    mem_lat: int = 300  # local DRAM access latency (~100 ns)
    mlp: int = 16  # outstanding-miss window before a core stalls (OoO MSHRs)
    n_cores: int = 4  # threads per application (Sniper-style multicore CC)
    gap_scale: float = 0.25  # compute-gap scale (OoO cores retire ~4 IPC)

    # network / MCs
    n_mcs: int = 1
    bus_bw: float = 32.0  # bytes/cycle (~96 GB/s @ 3 GHz)
    link_bw_frac: float = 0.25  # network bw = frac * bus bw (1/2 .. 1/8)
    net_lat: int = 3000  # one-way propagation+protocol (~1 us)
    remote_mem_lat: int = 300  # DRAM access at the MC
    # page -> MC placement (§2.3 / §2.13 of DESIGN.md): any registered
    # placement policy (memside.available_placements).  The legacy static
    # trio ("page" / "hash" / "single") with mc_capacity_pages=None keeps
    # the infinite-memory fast path, bit-identical to every committed
    # golden; "first_touch" / "capacity_aware" (or finite capacity) turn
    # on the memory-side state subsystem.
    mc_interleave: str = "page"
    # finite per-MC capacity (§2.13): page slots per memory module, backed
    # by a slab/first-fit allocator with cross-MC spill (charged as extra
    # fabric hops) and coldest-resident eviction when the pool fills.
    # ``None`` (default) is the legacy infinite passive address space —
    # bit-identical to every committed golden.
    mc_capacity_pages: Optional[int] = None
    # hot-page dynamics (§2.13, finite capacity only): line fetches to a
    # still-remote resident before the engines promote it toward the
    # owning CC's page cache (throttled by the controller's backlog
    # signal; eviction writebacks ride the §2.7 uplink)
    mem_hot_threshold: int = 8

    # CC->MC uplink (§2.7 of DESIGN.md).  ``None`` (default) is the legacy
    # model: the request path is folded into ``net_lat`` and dirty-page
    # writebacks are injected into the *downlink* queue — bit-identical to
    # every committed golden.  A float (bytes/cycle) makes the reverse path
    # a first-class contended resource: line/page request packets
    # (``header_bytes`` each) and writebacks queue on a per-MC uplink whose
    # arbitration follows the policy's ``uplink`` component.  Disaggregated
    # fabrics are commonly asymmetric (uplink_bw < link_bw).
    uplink_bw: Optional[float] = None
    # dual-queue uplinks: bandwidth fraction of the writeback (bulk) class
    # when both classes are backlogged; request packets keep the rest
    # (mirrors line_share on the downlink).
    writeback_share: float = 0.4

    # routed network fabric (§2.11 of DESIGN.md).  ``None`` (default) is the
    # legacy flat model: one private link per MC and direction, bit-identical
    # to every committed golden.  A registered topology name (fabric.py:
    # direct / single_switch / two_tier) routes every CC<->MC transfer over
    # an explicit multi-hop path of directed ports with store-and-forward
    # switching (``switch_lat`` cycles of processing per switch hop) and
    # per-port fluid arbitration.  ``oversub`` provisions the two_tier spine
    # trunks at aggregate_endpoint_bw/oversub (>= 1.0; inert for direct and
    # single_switch, and accepted there so sweep axes stay composable).
    topology: Optional[str] = None
    oversub: float = 1.0
    switch_lat: int = 500  # store-and-forward processing per switch hop

    # scenario axis: time-varying network (§5 of DESIGN.md).  Models fabric
    # congestion: each link resamples per ``jitter_period`` cycles an
    # *available*-bandwidth multiplier 1 - bw_jitter*U[0,1) (floored at 0.05;
    # capacity is the ceiling, dips below it) and a latency multiplier
    # 1 + lat_jitter*U[0,1) (propagation is the floor, queueing adds to it).
    # Zero jitter is the exact legacy fixed-network model.
    bw_jitter: float = 0.0
    lat_jitter: float = 0.0
    jitter_period: int = 20_000  # cycles per variability epoch (~6.7 us)
    jitter_seed: int = 0

    # DaeMon
    line_share: float = 0.6  # bandwidth fraction reserved for the sub-block queue
    inflight_lines: int = 128  # inflight sub-block buffer capacity
    inflight_pages: int = 16  # inflight page buffer capacity
    page_throttle_hi: float = 0.75  # stop issuing pages above this utilization
    # movement controller (§2.12 of DESIGN.md): the registered
    # MovementController driving the selection/throttle/compression
    # decisions on every CC.  ``None`` resolves to the legacy ``fixed``
    # constants — bit-identical to every committed golden.  A policy's
    # explicit ``controller`` component overrides this per CC.
    controller: Optional[str] = None
    compress: bool = True
    comp_lat: int = 750  # page compression latency at the MC (~250 ns)
    decomp_lat: int = 750  # page decompression latency at the CC

    # request-level serving layer (§2.9 of DESIGN.md).  ``serving_router``
    # is ``None`` by default — the legacy closed-loop model, no request
    # layer, bit-identical to every committed golden.  A registered
    # RouterPolicy name (serving.py: round_robin / least_loaded /
    # disagg_prefill) turns the cell into an open-loop LLM-serving
    # simulation: Poisson arrivals at ``offered_load`` requests per Mcycle,
    # each request one ``prefill_workload`` burst of ``prefill_accesses``
    # followed by ``decode_steps`` x ``decode_accesses`` slices of
    # ``decode_workload``, scheduled onto per-CC request slots (n_cores).
    serving_router: Optional[str] = None
    offered_load: float = 4.0  # requests per 1e6 cycles (open loop)
    n_requests: int = 32
    # the captured Hopper streams (port seam (c); the original names its
    # Pallas captures here)
    prefill_workload: str = "fa_prefill_h100"
    decode_workload: str = "fa_decode_h100"
    prefill_accesses: int = 1024
    decode_steps: int = 4
    decode_accesses: int = 256
    # fraction of CCs in the prefill pool for disaggregated routers
    serving_prefill_frac: float = 0.5
    # per-pool MovementPolicy overrides (registered policy names) for
    # disaggregated routers; None = the cell's scheme on every CC
    serving_prefill_policy: Optional[str] = None
    serving_decode_policy: Optional[str] = None
    # per-pool MovementController overrides (registered controller names)
    # for disaggregated routers, mirroring the per-pool policy overrides;
    # None = the cell's controller resolution on every CC
    serving_prefill_controller: Optional[str] = None
    serving_decode_controller: Optional[str] = None
    # stop firing events past this cycle horizon (None = drain all requests)
    serving_horizon: Optional[float] = None

    def __post_init__(self):
        """Fail-fast validation at config construction time (DESIGN.md §2.1)
        — a bad parameter should never survive until deep inside a sweep."""
        # placements (§2.13) — names resolve against the registry at
        # construction time, like policies/workloads/topologies
        if self.mc_interleave not in available_placements():
            raise ValueError(
                f"mc_interleave={self.mc_interleave!r} not registered; "
                f"choose from {available_placements()}")
        if self.mc_capacity_pages is not None and self.mc_capacity_pages < 1:
            raise ValueError(
                f"mc_capacity_pages={self.mc_capacity_pages} must be >= 1 "
                f"(or None for the legacy infinite model)")
        if self.mem_hot_threshold < 1:
            raise ValueError(
                f"mem_hot_threshold={self.mem_hot_threshold} must be >= 1")
        for name, lo in (("n_ccs", 1), ("n_mcs", 1), ("n_cores", 1),
                         ("line_bytes", 1), ("page_bytes", 1), ("mlp", 1)):
            if getattr(self, name) < lo:
                raise ValueError(f"{name}={getattr(self, name)} must be >= {lo}")
        if self.page_bytes % self.line_bytes:
            raise ValueError(
                f"page_bytes={self.page_bytes} must be a multiple of "
                f"line_bytes={self.line_bytes}")
        for name in ("bus_bw", "link_bw_frac", "local_mem_frac", "gap_scale"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name}={getattr(self, name)} must be > 0")
        if not (0.0 < self.line_share < 1.0):
            raise ValueError(f"line_share={self.line_share} must be in (0, 1)")
        if self.uplink_bw is not None and self.uplink_bw <= 0:
            raise ValueError(
                f"uplink_bw={self.uplink_bw} must be > 0 (or None for the "
                f"legacy folded-into-net_lat model)")
        if not (0.0 < self.writeback_share < 1.0):
            raise ValueError(
                f"writeback_share={self.writeback_share} must be in (0, 1)")
        # routed fabric (§2.11) — topology names resolve against the
        # registry at construction time, like policies and workloads
        if self.topology is not None and \
                self.topology not in available_topologies():
            raise ValueError(
                f"topology={self.topology!r} not registered; choose from "
                f"{available_topologies()} (or None for the legacy flat "
                f"per-MC links)")
        if self.oversub < 1.0:
            raise ValueError(
                f"oversub={self.oversub} must be >= 1.0 "
                f"(1.0 = non-blocking trunks)")
        if self.switch_lat < 0:
            raise ValueError(
                f"switch_lat={self.switch_lat} must be >= 0")
        # movement controllers (§2.12) — names resolve against the registry
        # at construction time, like policies/workloads/topologies
        for name in ("controller", "serving_prefill_controller",
                     "serving_decode_controller"):
            v = getattr(self, name)
            if v is not None and v not in available_controllers():
                raise ValueError(
                    f"{name}={v!r} not registered; choose from "
                    f"{available_controllers()} (or None for the legacy "
                    f"fixed constants)")
        for name in ("bw_jitter", "lat_jitter"):
            if not (0.0 <= getattr(self, name) <= 1.0):
                raise ValueError(
                    f"{name}={getattr(self, name)} must be in [0, 1]")
        # serving layer (§2.9) — validated whether or not a router is set,
        # so a bad sweep axis value fails at config construction time
        for name in ("n_requests", "prefill_accesses", "decode_accesses"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 1")
        if self.decode_steps < 0:
            raise ValueError(f"decode_steps={self.decode_steps} must be >= 0")
        if self.offered_load <= 0:
            raise ValueError(
                f"offered_load={self.offered_load} must be > 0 "
                f"(requests per Mcycle)")
        if not (0.0 < self.serving_prefill_frac < 1.0):
            raise ValueError(
                f"serving_prefill_frac={self.serving_prefill_frac} "
                f"must be in (0, 1)")
        if self.serving_horizon is not None and self.serving_horizon <= 0:
            raise ValueError(
                f"serving_horizon={self.serving_horizon} must be > 0 "
                f"(or None to drain all requests)")

    @property
    def link_bw(self) -> float:
        return self.bus_bw * self.link_bw_frac

    def with_(self, **kw) -> "SimConfig":
        return replace(self, **kw)


@dataclass
class Metrics:
    scheme: str = ""
    workload: str = ""
    cycles: float = 0.0  # end-to-end execution time
    accesses: int = 0
    llc_hits: int = 0
    local_hits: int = 0
    remote_misses: int = 0
    miss_latency_sum: float = 0.0  # total cycles spent servicing LLC misses
    net_bytes: float = 0.0  # bytes transmitted MC->CC (downlink; with the
    # legacy uplink_bw=None model this also includes writeback bytes)
    uplink_bytes: float = 0.0  # bytes transmitted CC->MC (request packets +
    # writebacks); always 0 under the legacy uplink_bw=None model
    pages_moved: int = 0
    lines_moved: int = 0
    writebacks: int = 0  # dirty-page evictions written back to the MC
    bytes_saved_compression: float = 0.0
    # count of stall *episodes* (each time a core's mlp window fills), NOT
    # stalled cycles — see DESIGN.md §2.2
    stall_episodes: float = 0.0
    # memory-side state counters (§2.13): cell-global (the pool is shared
    # across CCs, so these are not attributed per CC — per_cc entries
    # carry zeros); all-zero under the legacy infinite model.
    mc_spills: int = 0      # allocations that landed off their home MC
    mc_evictions: int = 0   # cold residents dropped from a full pool
    mc_promotions: int = 0  # hot-page migrations issued toward a CC
    # multi-CC rollup (§2.5): one entry per CC (cc index, per-CC workload,
    # and the full per-CC counter set); empty for single-CC runs, where the
    # aggregate IS the (only) CC's metrics.
    per_cc: list = field(default_factory=list)
    # request-level serving rollup (§2.9): populated only by serve_one
    # (cfg.serving_router set); all-zero/empty for legacy closed-loop runs.
    requests_offered: int = 0
    requests_completed: int = 0
    request_p50: float = 0.0  # median request latency (cycles)
    request_p99: float = 0.0  # tail request latency (cycles)
    goodput: float = 0.0  # completed requests per Mcycle of makespan
    requests: list = field(default_factory=list)  # per-request records

    @property
    def avg_access_cost(self) -> float:
        """Average LLC-miss service latency — the paper's 'data access cost'."""
        n = self.llc_misses
        return self.miss_latency_sum / n if n else 0.0

    @property
    def llc_misses(self) -> int:
        return self.local_hits + self.remote_misses

    def as_dict(self) -> dict:
        return {
            "scheme": self.scheme,
            "workload": self.workload,
            "cycles": self.cycles,
            "avg_access_cost": self.avg_access_cost,
            "accesses": self.accesses,
            "net_bytes": self.net_bytes,
            "uplink_bytes": self.uplink_bytes,
            "pages_moved": self.pages_moved,
            "lines_moved": self.lines_moved,
            "writebacks": self.writebacks,
            "llc_hits": self.llc_hits,
            "local_hits": self.local_hits,
            "remote_misses": self.remote_misses,
            "miss_latency_sum": self.miss_latency_sum,
            "stall_episodes": self.stall_episodes,
            "bytes_saved_compression": self.bytes_saved_compression,
            "mc_spills": self.mc_spills,
            "mc_evictions": self.mc_evictions,
            "mc_promotions": self.mc_promotions,
            "per_cc": self.per_cc,
            "requests_offered": self.requests_offered,
            "requests_completed": self.requests_completed,
            "request_p50": self.request_p50,
            "request_p99": self.request_p99,
            "goodput": self.goodput,
            "requests": self.requests,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Metrics":
        """Inverse of :meth:`as_dict` (derived keys are ignored)."""
        fields = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**fields)
