"""Memory-side resident state (DESIGN.md §2.13): allocation, placement,
finite per-MC capacity, and hot-page dynamics.

The paper evaluates DaeMon against an *infinite passive* remote address
space: a page lives forever at the MC a pure function of its address
picks (``engine.mc_place``).  Real disaggregated pools have finite
per-module capacity, allocation/placement policy, and hot-page churn —
the dominant open problems in memory-pool management (Maruf & Chowdhury;
Wang et al.).  This module grows the static ``mc_interleave`` axis into
that subsystem:

- A ``@register_placement`` registry of first-class placement policies.
  The legacy modes ``page`` / ``hash`` / ``single`` re-register as
  compositions of the same arithmetic ``engine.mc_place`` uses (kept in
  lockstep by tests), joined by ``first_touch`` (NUMA-style owning-CC
  affinity) and ``capacity_aware`` (least-loaded at allocation time).
- :class:`MemsideState`: one per-cell state object holding the page
  table (resident MC per (cc, page)), a slab/first-fit allocator per MC
  (``SimConfig.mc_capacity_pages`` slots), cross-MC spill when a module
  fills (charged as extra fabric hops on every transfer touching the
  spilled page), eviction of the coldest resident when the whole pool is
  full, and an access-frequency tracker that raises a promotion signal
  for hot still-remote pages (the engines turn it into a page migration
  toward the owning CC, throttled by the controller's backlog signal).

Bit-parity contract: ``make_memside`` returns ``None`` for the legacy
model (``mc_capacity_pages=None`` and a legacy placement) and the
engines then keep their original expressions untouched — the committed
GOLD/GOLD_MCC goldens stay bit-identical.  When active, BOTH engines
drive the *same* :class:`MemsideState` instance shape at the same event
points with the same arguments (the §2.12 observe/decide discipline:
``touch`` mutates, ``peek`` is pure), so batch==python parity holds by
construction rather than by transcription.

This is a leaf module (stdlib only): ``config.py`` imports it for
fail-fast ``mc_interleave`` validation and the engines import it for the
state object, with no import cycles.
"""
from __future__ import annotations

from dataclasses import dataclass
from heapq import heappop, heappush
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# the legacy static modes: with mc_capacity_pages=None these keep the
# engines on their original mc_place() fast path (golden bit-parity)
LEGACY_PLACEMENTS = ("page", "hash", "single")


# --------------------------------------------------------------------------
# placement registry
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PlacementPolicy:
    """One registered placement policy.  ``home(cc, page, n_mcs, occ)``
    picks the page's home MC at allocation time; ``occ`` is the live
    per-MC allocated-page count (read-only — how ``capacity_aware``
    implements least-loaded).  ``allocator`` is the short slot-selection
    label shown by ``run.py --list``."""

    name: str
    allocator: str
    description: str = ""
    home: Callable[[int, int, int, Sequence[int]], int] = None

    def __call__(self, cc: int, page: int, n_mcs: int,
                 occ: Sequence[int]) -> int:
        return self.home(cc, page, n_mcs, occ)


_PLACEMENTS: Dict[str, PlacementPolicy] = {}


def register_placement(name: str, *, allocator: str = "static",
                       description: str = "", overwrite: bool = False):
    """Decorator: register ``fn(cc, page, n_mcs, occ) -> mc`` as a
    placement policy (mirrors the policy/workload/controller registries;
    duplicate names raise unless ``overwrite``)."""

    def deco(fn):
        if name in _PLACEMENTS and not overwrite:
            raise ValueError(
                f"placement {name!r} already registered "
                f"(pass overwrite=True to replace)")
        _PLACEMENTS[name] = PlacementPolicy(
            name=name, allocator=allocator, description=description, home=fn)
        return fn

    return deco


def unregister_placement(name: str) -> None:
    _PLACEMENTS.pop(name, None)


def get_placement(name) -> PlacementPolicy:
    """Resolve a placement by name; unknown names fail fast listing
    choices (the config/sweep entry points route through here)."""
    if isinstance(name, PlacementPolicy):
        return name
    p = _PLACEMENTS.get(name)
    if p is None:
        raise KeyError(
            f"unknown placement {name!r}; registered placements: "
            f"{', '.join(available_placements())}")
    return p


def available_placements() -> Tuple[str, ...]:
    return tuple(_PLACEMENTS)


# legacy static modes: the home expressions mirror engine.mc_place arm
# for arm (tests/test_memside.py locks them together) so re-registering
# them here cannot drift from the golden path


@register_placement(
    "page", allocator="static",
    description="round-robin interleave: page % n_mcs (legacy default)")
def _home_page(cc: int, page: int, n_mcs: int, occ: Sequence[int]) -> int:
    return page % n_mcs


@register_placement(
    "hash", allocator="static",
    description="Fibonacci hash of the page number: immune to "
                "power-of-two strides (legacy 'hash')")
def _home_hash(cc: int, page: int, n_mcs: int, occ: Sequence[int]) -> int:
    return (((page * 0x9E3779B1) & 0xFFFFFFFF) >> 7) % n_mcs


@register_placement(
    "single", allocator="static",
    description="everything on MC 0: one-module pool (legacy 'single')")
def _home_single(cc: int, page: int, n_mcs: int, occ: Sequence[int]) -> int:
    return 0


@register_placement(
    "first_touch", allocator="affine",
    description="NUMA-style first touch: a page's home is its owning "
                "CC's affine module (cc % n_mcs) — best locality, worst "
                "balance under skewed tenancy")
def _home_first_touch(cc: int, page: int, n_mcs: int,
                      occ: Sequence[int]) -> int:
    return cc % n_mcs


@register_placement(
    "capacity_aware", allocator="least_loaded",
    description="least-loaded at allocation time: the MC with the "
                "fewest resident pages (ties: lowest index)")
def _home_capacity_aware(cc: int, page: int, n_mcs: int,
                         occ: Sequence[int]) -> int:
    best = 0
    lo = occ[0]
    for j in range(1, n_mcs):
        if occ[j] < lo:
            lo = occ[j]
            best = j
    return best


# --------------------------------------------------------------------------
# per-cell memory-side state
# --------------------------------------------------------------------------


class MemsideState:
    """Resident-page state for one simulation cell, shared by both
    engines (one instance per Simulator / per batch _Frame).

    Determinism: every structure is a dict/list/heap over ints mutated
    only by ``touch`` — which both engines call at the same four
    transfer-issue points (line fetch, daemon line fetch, page send,
    writeback send) in the same event order — so python and batch runs
    stay bit-identical.  ``peek`` is pure (the controller-observation
    hook may be evaluated a different number of times per engine, per
    the §2.12 observe/decide split).
    """

    __slots__ = ("n_mcs", "capacity", "hot_threshold", "switch_lat",
                 "placement", "table", "occ", "resid", "hops", "slot",
                 "free_slots", "spills", "evictions", "promotions")

    def __init__(self, n_mcs: int, placement, capacity: Optional[int],
                 hot_threshold: int, switch_lat: float):
        self.n_mcs = max(1, n_mcs)
        self.placement = get_placement(placement)
        self.capacity = capacity
        self.hot_threshold = max(1, hot_threshold)
        self.switch_lat = float(switch_lat)
        # page table: (cc, page) -> resident MC
        self.table: Dict[Tuple[int, int], int] = {}
        # per-MC allocated-page counts (the placement's 'occ' view)
        self.occ: List[int] = [0] * self.n_mcs
        # per-MC residents in allocation order: (cc, page) -> access count
        # (line fetches since allocation/promotion; the hotness signal)
        self.resid: List[Dict[Tuple[int, int], int]] = [
            {} for _ in range(self.n_mcs)]
        # spilled pages: (cc, page) -> ring hops from home (extra fabric
        # hops charged on every transfer touching the page)
        self.hops: Dict[Tuple[int, int], int] = {}
        # slab bookkeeping (finite capacity only): first-fit slot index
        # per resident, lowest free slot first
        if capacity is None:
            self.slot = None
            self.free_slots = None
        else:
            self.slot = {}
            self.free_slots = [list(range(capacity))
                               for _ in range(self.n_mcs)]
        self.spills = 0      # allocations that landed off their home MC
        self.evictions = 0   # cold residents dropped from a full pool
        self.promotions = 0  # hot-page migrations issued by the engines

    # -- pure reads --
    def peek(self, cc: int, page: int) -> int:
        """Resident MC if allocated, else the placement's would-be home.
        Pure: safe from controller-observation paths that the two
        engines evaluate a different number of times."""
        if self.n_mcs <= 1:
            return 0
        mc = self.table.get((cc, page))
        if mc is None:
            return self.placement.home(cc, page, self.n_mcs, self.occ)
        return mc

    def resident_mc(self, cc: int, page: int) -> Optional[int]:
        return self.table.get((cc, page))

    # -- the single mutation point --
    def touch(self, cc: int, page: int,
              kind: str) -> Tuple[int, float, bool]:
        """Resolve the resident MC for one transfer and update state.

        ``kind`` is ``'line'`` (line fetch: counts toward hotness),
        ``'page'`` (page migration: resets the hotness count — the page
        just moved toward the CC), or ``'wb'`` (writeback: re-allocates
        an evicted backing page, no hotness change).  Returns ``(mc,
        extra_lat, promote)``: the resident MC, the extra fabric-hop
        latency for spilled residents (ring hops x switch_lat), and the
        hot-page promotion signal (finite capacity only; fires once per
        hot_threshold line fetches, then re-arms)."""
        key = (cc, page)
        mc = self.table.get(key)
        if mc is None:
            mc = self._alloc(key)
        promote = False
        res = self.resid[mc]
        if kind == "line":
            n = res[key] + 1
            if self.capacity is not None and n >= self.hot_threshold:
                res[key] = 0
                promote = True
            else:
                res[key] = n
        elif kind == "page":
            res[key] = 0
        h = self.hops.get(key)
        return mc, (h * self.switch_lat if h else 0.0), promote

    # -- allocation / spill / eviction --
    def _alloc(self, key: Tuple[int, int]) -> int:
        cc, page = key
        n = self.n_mcs
        home = (0 if n <= 1
                else self.placement.home(cc, page, n, self.occ))
        cap = self.capacity
        mc = home
        if cap is not None and self.occ[home] >= cap:
            # first-fit ring scan from the home module upward
            mc = -1
            for d in range(1, n):
                j = home + d
                if j >= n:
                    j -= n
                if self.occ[j] < cap:
                    mc = j
                    break
            if mc < 0:
                # whole pool full: evict the coldest resident at home
                self._evict_coldest(home)
                mc = home
            else:
                self.spills += 1
        self.table[key] = mc
        self.occ[mc] += 1
        self.resid[mc][key] = 0
        if self.free_slots is not None:
            self.slot[key] = heappop(self.free_slots[mc])
        if mc != home:
            d = mc - home
            if d < 0:
                d += n
            self.hops[key] = d if d <= n - d else n - d  # ring distance
        return mc

    def _evict_coldest(self, mc: int) -> Tuple[int, int]:
        """Drop the coldest resident (lowest access count; allocation
        order breaks ties) from MC ``mc``, freeing its slab slot.  The
        page's next transfer re-allocates it fresh."""
        res = self.resid[mc]
        victim = None
        best = -1
        for k, cnt in res.items():
            if victim is None or cnt < best:
                victim = k
                best = cnt
        if victim is None:
            raise RuntimeError(f"evict from empty MC {mc}")
        del res[victim]
        del self.table[victim]
        self.occ[mc] -= 1
        self.hops.pop(victim, None)
        if self.free_slots is not None:
            heappush(self.free_slots[mc], self.slot.pop(victim))
        self.evictions += 1
        return victim


def make_memside(n_mcs: int, placement: str, capacity: Optional[int],
                 hot_threshold: int, switch_lat: float
                 ) -> Optional[MemsideState]:
    """Build the per-cell state, or ``None`` for the legacy infinite
    model (a legacy placement and no capacity) — the engines then keep
    their original mc_place expressions untouched, preserving the
    committed goldens bit for bit."""
    if capacity is None and placement in LEGACY_PLACEMENTS:
        return None
    return MemsideState(n_mcs, placement, capacity, hot_threshold,
                        switch_lat)
