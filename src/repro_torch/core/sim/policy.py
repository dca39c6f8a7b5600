"""Composable data-movement policies (DESIGN.md §2.6).

The paper's core claim is that DaeMon's gains come from the *synergy* of
four orthogonal techniques — decoupled multi-granularity movement,
bandwidth partitioning, link compression, and adaptive granularity
selection.  A :class:`MovementPolicy` names one value per component, the
engine dispatches on components (never on policy names), and the
``@register_policy`` registry makes every composition a first-class,
string-addressable citizen of ``run_one`` / ``Sweep`` axes / benchmark
CLIs.

The six legacy schemes are registered compositions that reproduce the
pre-registry engine bit-for-bit (locked by tests/test_multicc.py goldens);
ablation policies (``daemon_nocomp``, ``daemon_fifo``, ``daemon_fixed_gran``,
``both_dualq``, ``page_dualq``) are just more compositions — no engine
edits.  Define your own in ~5 lines:

    from repro_torch.core.sim import MovementPolicy, register_policy, run_one

    register_policy(MovementPolicy(
        name="daemon_lowshare", granularity="adaptive", partitioning="dual",
        compression="link", throttle=True, line_share=0.3))
    run_one("pr", "daemon_lowshare")
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.core.sim.controller import available_controllers

GRANULARITIES = ("none", "line", "page", "both", "adaptive")
PARTITIONINGS = ("fifo", "dual")
COMPRESSIONS = ("off", "link")
UPLINKS = (None, "fifo", "dual")
FABRICS = (None, "fifo", "dual")


@dataclass(frozen=True)
class MovementPolicy:
    """One data-movement policy as a composition of orthogonal components.

    granularity — what an LLC miss moves over the network:
        ``none``      nothing (monolithic local-memory upper bound);
        ``line``      the 64 B line only, no local-memory migration;
        ``page``      the 4 KiB page only (requests ride the migration);
        ``both``      line AND page for every triggering miss (fixed);
        ``adaptive``  DaeMon's selection unit: inflight-buffer utilization
                      decides when to race lines and skip redundant ones.
    partitioning — how the downlink arbitrates line vs page traffic:
        ``fifo``      one store-and-forward queue, transfers serialize;
        ``dual``      decoupled queues, the line class keeps ``line_share``
                      of the bandwidth whenever it is backlogged.
    uplink — how the CC->MC uplink (active only when ``SimConfig.uplink_bw``
        is set; DESIGN.md §2.7) arbitrates request packets vs writeback
        bulk: ``fifo`` (requests suffer head-of-line blocking behind 4 KiB
        writebacks), ``dual`` (requests keep ``1 - writeback_share`` of the
        uplink whenever backlogged), or ``None`` (default) to follow the
        ``partitioning`` component — daemon protects its request packets,
        FIFO baselines do not.
    fabric — how *switch-owned* fabric ports arbitrate when
        ``SimConfig.topology`` routes transfers through switches
        (DESIGN.md §2.11): ``fifo`` / ``dual`` force that arbitration on
        every switch hop, or ``None`` (default) to follow the direction's
        endpoint arbitration (``partitioning`` downlink, ``uplink``
        uplink) — daemon keeps its protected line class end-to-end on
        every hop, FIFO baselines stay FIFO on every hop.  Endpoint NIC
        ports always follow the endpoint components, so the ``direct``
        topology reproduces the flat model whatever this is set to.
    compression — ``off`` or ``link``: congestion-triggered page
        compression at the MC (per-workload ratios; paper §3-III).
        ``link`` still honors the global ``SimConfig.compress`` switch.
    throttle — inflight-buffer caps + retry queue (part of the paper's
        selection unit): pages stop issuing above ``page_throttle_hi``
        utilization, misses park in a retry queue when both buffers fill.
    free_transfers — pages arrive at zero network cost (the idealized
        locality bound; ``page_free``).
    page_carries_requests — whether requests attach to an inflight page
        migration and complete on its arrival.  ``False`` is the legacy
        ``both`` race semantics: the line carries the request and the page
        is pure prefetch.  Only meaningful for ``both`` granularity.
    line_share — per-policy override of ``SimConfig.line_share`` for
        ``dual`` partitioning (``None`` = use the config's value).
    controller — the registered :class:`MovementController` driving this
        policy's selection/throttle/compression decisions (DESIGN.md
        §2.12).  ``None`` (default) follows ``SimConfig.controller``,
        which itself defaults to the legacy ``fixed`` constants; an
        explicit name here wins over the config (the serving layer's
        per-pool overrides ride this precedence).
    """

    name: str
    granularity: str = "adaptive"
    partitioning: str = "dual"
    uplink: Optional[str] = None
    fabric: Optional[str] = None
    compression: str = "link"
    throttle: bool = True
    free_transfers: bool = False
    page_carries_requests: bool = True
    line_share: Optional[float] = None
    controller: Optional[str] = None
    description: str = ""

    def __post_init__(self):
        if not self.name or "+" in self.name or "/" in self.name:
            raise ValueError(f"bad policy name {self.name!r}")
        if self.granularity not in GRANULARITIES:
            raise ValueError(
                f"policy {self.name!r}: granularity={self.granularity!r} "
                f"not in {GRANULARITIES}")
        if self.partitioning not in PARTITIONINGS:
            raise ValueError(
                f"policy {self.name!r}: partitioning={self.partitioning!r} "
                f"not in {PARTITIONINGS}")
        if self.uplink not in UPLINKS:
            raise ValueError(
                f"policy {self.name!r}: uplink={self.uplink!r} "
                f"not in {UPLINKS}")
        if self.fabric not in FABRICS:
            raise ValueError(
                f"policy {self.name!r}: fabric={self.fabric!r} "
                f"not in {FABRICS}")
        if self.compression not in COMPRESSIONS:
            raise ValueError(
                f"policy {self.name!r}: compression={self.compression!r} "
                f"not in {COMPRESSIONS}")
        if not self.page_carries_requests and self.granularity != "both":
            raise ValueError(
                f"policy {self.name!r}: page_carries_requests=False is the "
                f"legacy 'both' race semantics; granularity must be 'both'")
        if self.free_transfers and self.granularity != "page":
            raise ValueError(
                f"policy {self.name!r}: free_transfers requires "
                f"granularity='page'")
        if self.line_share is not None and not (0.0 < self.line_share < 1.0):
            raise ValueError(
                f"policy {self.name!r}: line_share={self.line_share} "
                f"must be in (0, 1)")
        if self.controller is not None and \
                self.controller not in available_controllers():
            raise ValueError(
                f"policy {self.name!r}: controller={self.controller!r} "
                f"not registered; choose from {available_controllers()} "
                f"(or None to follow SimConfig.controller)")

    @property
    def moves_pages(self) -> bool:
        return self.granularity in ("page", "both", "adaptive")

    @property
    def uplink_partitioning(self) -> str:
        """The resolved uplink arbitration: explicit ``uplink``, else the
        downlink ``partitioning`` component."""
        return self.uplink if self.uplink is not None else self.partitioning

    def with_(self, **kw) -> "MovementPolicy":
        """Derive a variant (give it a new ``name`` before registering)."""
        return replace(self, **kw)

    def components(self) -> Dict[str, object]:
        """The component matrix row for docs / ``benchmarks.run --list``."""
        return {
            "granularity": self.granularity,
            "partitioning": self.partitioning,
            "uplink": self.uplink_partitioning,
            "fabric": self.fabric,
            "compression": self.compression,
            "throttle": self.throttle,
            "free_transfers": self.free_transfers,
            "page_carries_requests": self.page_carries_requests,
            "line_share": self.line_share,
            "controller": self.controller,
        }


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_POLICIES: Dict[str, MovementPolicy] = {}

PolicyLike = Union[MovementPolicy, Callable[[], MovementPolicy]]


def register_policy(obj: PolicyLike, *, overwrite: bool = False) -> PolicyLike:
    """Register a :class:`MovementPolicy` under its ``name``.

    Accepts a policy instance or (decorator form) a zero-arg factory
    returning one.  Duplicate names raise unless ``overwrite=True``.
    Returns ``obj`` unchanged so it composes as a decorator.
    """
    pol = obj() if callable(obj) and not isinstance(obj, MovementPolicy) else obj
    if not isinstance(pol, MovementPolicy):
        raise TypeError(f"register_policy needs a MovementPolicy, got {pol!r}")
    if pol.name in _POLICIES and not overwrite:
        raise ValueError(
            f"policy {pol.name!r} already registered "
            f"(pass overwrite=True to replace)")
    _POLICIES[pol.name] = pol
    return obj


def unregister_policy(name: str) -> None:
    """Remove a registered policy (tests / interactive experimentation)."""
    _POLICIES.pop(name, None)


def get_policy(name: Union[str, MovementPolicy]) -> MovementPolicy:
    """Resolve a policy by name; unknown names fail fast listing choices."""
    if isinstance(name, MovementPolicy):
        return name
    pol = _POLICIES.get(name)
    if pol is None:
        raise KeyError(
            f"unknown policy {name!r}; registered policies: "
            f"{', '.join(available_policies())}")
    return pol


def available_policies() -> Tuple[str, ...]:
    return tuple(_POLICIES)


# --------------------------------------------------------------------------
# built-in compositions
# --------------------------------------------------------------------------

# the six legacy schemes, bit-identical to the pre-registry engine
register_policy(MovementPolicy(
    name="local", granularity="none", partitioning="fifo", compression="off",
    throttle=False,
    description="monolithic upper bound: every LLC miss is a local DRAM access"))
register_policy(MovementPolicy(
    name="cacheline", granularity="line", partitioning="fifo",
    compression="off", throttle=False,
    description="move only 64 B lines into the LLC (no local-memory migration)"))
register_policy(MovementPolicy(
    name="page", granularity="page", partitioning="fifo", compression="off",
    throttle=False,
    description="migrate 4 KiB pages into local memory over a FIFO link"))
register_policy(MovementPolicy(
    name="page_free", granularity="page", partitioning="fifo",
    compression="off", throttle=False, free_transfers=True,
    description="page scheme with zero-cost transfers (idealized locality bound)"))
register_policy(MovementPolicy(
    name="both", granularity="both", partitioning="fifo", compression="off",
    throttle=False, page_carries_requests=False,
    description="naive line+page race on the SAME FIFO link; the line "
                "carries the request, the page is pure prefetch"))
register_policy(MovementPolicy(
    name="daemon", granularity="adaptive", partitioning="dual",
    compression="link", throttle=True,
    description="DaeMon: decoupled dual-queue partitioning + adaptive "
                "selection unit + congestion-triggered link compression"))

# ablation compositions (paper's technique-by-technique decomposition):
# daemon_nocomp / daemon_fifo / daemon_fixed_gran each remove exactly one
# technique; both_dualq keeps only decoupled movement + partitioning
register_policy(MovementPolicy(
    name="daemon_nocomp", granularity="adaptive", partitioning="dual",
    compression="off", throttle=True,
    description="daemon minus link compression"))
register_policy(MovementPolicy(
    name="daemon_fifo", granularity="adaptive", partitioning="fifo",
    compression="link", throttle=True,
    description="daemon minus bandwidth partitioning (lines queue behind "
                "pages on one FIFO)"))
register_policy(MovementPolicy(
    name="daemon_fixed_gran", granularity="both", partitioning="dual",
    compression="link", throttle=True,
    description="daemon minus adaptive selection: every triggering miss "
                "moves both granularities; coalesced misses never race "
                "extra lines"))
register_policy(MovementPolicy(
    name="both_dualq", granularity="both", partitioning="dual",
    compression="off", throttle=False,
    description="decoupled movement + partitioning alone: line+page for "
                "every miss on the dual-queue link, first arrival wins"))
register_policy(MovementPolicy(
    name="daemon_fabfifo", granularity="adaptive", partitioning="dual",
    compression="link", throttle=True, fabric="fifo",
    description="daemon with FIFO switch ports: dual-queue protection at "
                "the endpoint NICs only (fabric-partitioning ablation, "
                "§2.11; identical to daemon on topology=None/direct)"))
register_policy(MovementPolicy(
    name="page_dualq", granularity="page", partitioning="dual",
    compression="off", throttle=False,
    description="page scheme on the dual-queue link (no line traffic, so "
                "effectively the FIFO page scheme — a null ablation)"))

# serving-pool compositions (DESIGN.md §2.9): per-CC heterogeneous policy
# assignment for disaggregated prefill/decode routers.  Prefill-pool CCs
# stream page-dense KV-fill bursts — a low line share lets the bulk class
# drain; decode-pool CCs are latency-critical — a high line share protects
# their critical lines against the prefill pool's page bursts on the
# shared downlink (SharedHeteroLink uses the max share among dual flows).
register_policy(MovementPolicy(
    name="daemon_prefill", granularity="adaptive", partitioning="dual",
    compression="link", throttle=True, line_share=0.35,
    description="daemon tuned for prefill-pool CCs: bulk-friendly low "
                "line share"))
register_policy(MovementPolicy(
    name="daemon_decode", granularity="adaptive", partitioning="dual",
    compression="link", throttle=True, line_share=0.75,
    description="daemon tuned for decode-pool CCs: latency-protecting "
                "high line share"))
