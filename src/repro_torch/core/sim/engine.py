"""Event-driven simulator of a disaggregated system (CCs + MCs + network).

Data movement is governed by a composable :class:`~repro_torch.core.sim.policy.
MovementPolicy` (DESIGN.md §2.6): the engine dispatches on the policy's
orthogonal *components* — ``granularity`` (none/line/page/both/adaptive),
``partitioning`` (fifo/dual), ``compression`` (off/link), ``throttle`` —
never on policy names, so registering a new composition requires no engine
edits.  The paper's six schemes are the registered legacy compositions
(``local``, ``page``, ``page_free``, ``cacheline``, ``both``, ``daemon``),
bit-identical to the pre-registry engine.

The FIFO partitioning is store-and-forward (this is where critical lines
queue behind concurrently-moved pages — the paper's core pathology).  The
dual partitioning is DaeMon's fluid dual-queue: when both queues are busy
the sub-block queue drains at a fixed ``line_share`` of the bandwidth, i.e.
the paper's queue controller serving lines at a higher predefined fixed rate.

Scenario axes: every link optionally carries a :class:`LinkSchedule` — a
piecewise-constant per-epoch bandwidth/latency multiplier modeling runtime
network variability (DESIGN.md §5) — pages/lines are interleaved across
``n_mcs`` independent MC links per ``SimConfig.mc_interleave`` (DESIGN.md
§2.3), and ``n_ccs`` compute complexes, each with its own cores/LLC/local
page cache and (for daemon) its own engines, contend for the SAME per-MC
downlinks through per-CC flow arbitration (DESIGN.md §2.5).  ``n_ccs=1``
keeps the legacy single-CC links and reproduces the legacy model
bit-for-bit.

With ``SimConfig.uplink_bw`` set, the CC->MC direction becomes a
first-class contended resource too (DESIGN.md §2.7): line/page request
packets (~``header_bytes`` each) and dirty-page writebacks queue on a
per-MC *uplink* built from the same link machinery, arbitrated per the
policy's ``uplink`` component ('line' class = request packets, 'page'
class = writeback bulk), and CC-side writeback compression keys off the
uplink backlog.  ``uplink_bw=None`` (default) is the legacy model —
requests folded into ``net_lat``, writebacks injected into the downlink —
bit-identical to every committed golden.
"""
from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sim.config import Metrics, SimConfig
# PAGE_FAST / selection_races_line moved to controller.py (§2.12); the
# re-export keeps engine_batch.py and existing imports working
from repro_torch.core.sim.controller import (  # noqa: F401
    PAGE_FAST,
    Observation,
    make_controller,
    resolve_controller,
    selection_races_line,
)
from repro_torch.core.sim.fabric import Fabric, PortSpec, build_topology
from repro_torch.core.sim.memside import make_memside
from repro_torch.core.sim.policy import get_policy
from repro_torch.core.sim.trace import Trace, compressibility_of


# --------------------------------------------------------------------------
# event engine
# --------------------------------------------------------------------------


class Engine:
    def __init__(self):
        self.heap: List = []
        self._seq = itertools.count()
        self.now = 0.0

    def at(self, t: float, fn: Callable[[float], None]) -> None:
        heapq.heappush(self.heap, (t, next(self._seq), fn))

    def run(self, until: Optional[float] = None) -> float:
        """Drain the event heap; with ``until`` set, stop before the first
        event past that time (the serving layer's horizon cut, §2.9) —
        remaining events stay queued and ``now`` is the last fired time."""
        while self.heap:
            if until is not None and self.heap[0][0] > until:
                break
            t, _, fn = heapq.heappop(self.heap)
            self.now = t
            fn(t)
        return self.now


# --------------------------------------------------------------------------
# pure link/selection math, shared with the batch engine
# --------------------------------------------------------------------------
#
# These are the arithmetic kernels of the simulator — no state, no events.
# Both the oracle classes below and engine_batch.py call them, so the two
# engines cannot drift apart on the float expressions that decide completion
# times, fluid shares, placement, or selection-unit behaviour.  Any change
# here changes BOTH engines identically (and the committed goldens).
# PAGE_FAST and selection_races_line live in controller.py since the
# MovementController refactor (§2.12) and are re-exported above.


def fifo_finish(start: float, size: float, bw: float,
                sched: Optional["LinkSchedule"]) -> float:
    """Completion time of ``size`` bytes starting at ``start`` on a FIFO
    link, integrating the piecewise-constant bandwidth schedule across
    epoch boundaries (a plain ``size/bw`` when the schedule is inert)."""
    if sched is None or not sched.bw_active:
        return start + size / bw
    t, rem = start, size
    while True:
        b = bw * sched.bw_mult(t)
        nb = sched.next_boundary(t)
        cap = b * (nb - t)
        if rem <= cap:
            return t + rem / b
        rem -= cap
        t = nb


def fair_split(n_active: int, bw: float) -> float:
    """Per-lane rate under fluid fair share: k backlogged lanes each drain
    at bw/k (the fluid limit of round-robin packet arbitration)."""
    return bw / n_active


def class_share_split(n_lines: int, n_pages: int, bw: float,
                      line_share: float) -> Tuple[float, float]:
    """Per-lane (line_rate, page_rate) under DaeMon's fixed-rate queue
    controller: the line class keeps ``line_share`` of ``bw`` whenever both
    classes are backlogged, all of it when pages are idle (and vice versa);
    within a class the backlogged lanes share equally."""
    if n_lines and n_pages:
        lb, pb = line_share * bw, (1.0 - line_share) * bw
    elif n_lines:
        lb, pb = bw, 0.0
    else:
        lb, pb = 0.0, bw
    return (lb / n_lines if n_lines else 0.0,
            pb / n_pages if n_pages else 0.0)


def mc_place(page: int, n_mcs: int, mode: str) -> int:
    """Page -> MC link placement (DESIGN.md §2.3)."""
    if n_mcs <= 1:
        return 0
    if mode == "single":
        return 0
    if mode == "hash":  # Fibonacci hash: immune to power-of-two strides
        return (((page * 0x9E3779B1) & 0xFFFFFFFF) >> 7) % n_mcs
    return page % n_mcs


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


class LRU:
    """LRU cache over fixed-size entries; returns evicted (tag, dirty)."""

    __slots__ = ("cap", "d")

    def __init__(self, capacity: int):
        self.cap = max(1, capacity)
        self.d: OrderedDict = OrderedDict()

    def access(self, tag, dirty: bool = False) -> bool:
        if tag in self.d:
            self.d.move_to_end(tag)
            if dirty:
                self.d[tag] = True
            return True
        return False

    def insert(self, tag, dirty: bool = False):
        if tag in self.d:
            self.d.move_to_end(tag)
            self.d[tag] = self.d[tag] or dirty
            return None
        self.d[tag] = dirty
        if len(self.d) > self.cap:
            return self.d.popitem(last=False)
        return None

    def __contains__(self, tag):
        return tag in self.d


# --------------------------------------------------------------------------
# links
# --------------------------------------------------------------------------


class LinkSchedule:
    """Time-varying network model (DESIGN.md §5): piecewise-constant
    multipliers resampled once per ``period`` cycles, modeling fabric
    congestion — available bandwidth dips below nominal capacity
    (mult = 1 - bw_jitter*U[0,1), floored at 0.05) and latency spikes above
    the propagation floor (mult = 1 + lat_jitter*U[0,1)).

    Multipliers are a pure function of (seed, epoch index), so the "network
    weather" is identical across schemes, runs, and worker processes — a fair
    A/B environment by construction.  With both jitters zero the schedule is
    inert and links reproduce the legacy fixed-network results bit-for-bit.
    """

    __slots__ = ("period", "bw_jitter", "lat_jitter", "seed", "_cache")

    def __init__(self, period: int, bw_jitter: float, lat_jitter: float, seed: int = 0):
        self.period = max(1, int(period))
        self.bw_jitter = float(bw_jitter)
        self.lat_jitter = float(lat_jitter)
        self.seed = seed
        self._cache: Dict[int, Tuple[float, float]] = {}

    @property
    def bw_active(self) -> bool:
        return self.bw_jitter > 0.0

    @property
    def lat_active(self) -> bool:
        return self.lat_jitter > 0.0

    def _mults(self, epoch: int) -> Tuple[float, float]:
        m = self._cache.get(epoch)
        if m is None:
            rng = np.random.default_rng((self.seed, epoch))
            bw = max(0.05, 1.0 - self.bw_jitter * rng.random())
            lat = 1.0 + self.lat_jitter * rng.random()
            m = self._cache[epoch] = (bw, lat)
        return m

    def bw_mult(self, t: float) -> float:
        return self._mults(int(t // self.period))[0] if self.bw_active else 1.0

    def lat_mult(self, t: float) -> float:
        return self._mults(int(t // self.period))[1] if self.lat_active else 1.0

    def next_boundary(self, t: float) -> float:
        return (int(t // self.period) + 1) * float(self.period)


class FifoLink:
    """Store-and-forward FIFO: one queue, transfers fully serialize.

    Single-CC only (``flow`` is accepted for call-site uniformity and
    ignored); multi-CC systems use :class:`SharedFifoLink`."""

    def __init__(self, eng: Engine, bw: float, sched: Optional[LinkSchedule] = None):
        self.eng = eng
        self.bw = bw
        self.sched = sched
        self.busy_until = 0.0
        self.bytes = 0.0

    def _finish(self, start: float, size: float) -> float:
        """Completion time of ``size`` bytes starting at ``start``, integrating
        the piecewise-constant bandwidth schedule across epoch boundaries."""
        return fifo_finish(start, size, self.bw, self.sched)

    def send(self, t: float, size: float, cb: Callable[[float], None],
             cls: str = "line", flow: int = 0):
        start = max(t, self.busy_until)
        done = self._finish(start, size)
        self.busy_until = done
        self.bytes += size
        self.eng.at(done, cb)

    def backlog(self, t: float) -> float:
        """Outstanding bytes not yet transmitted (congestion signal,
        DESIGN.md §2.7): residual busy time x nominal bandwidth."""
        return max(0.0, self.busy_until - t) * self.bw


class DualQueueLink:
    """DaeMon's decoupled queues: fluid bandwidth partition between the
    sub-block (line) queue and the page queue.  Within a queue transfers
    serialize FIFO; across queues the line queue gets ``line_share`` of the
    bandwidth whenever it is non-empty (and all of it when pages are idle).

    Single-CC only (``flow`` ignored); multi-CC systems use
    :class:`SharedDualQueueLink`."""

    def __init__(self, eng: Engine, bw: float, line_share: float,
                 sched: Optional[LinkSchedule] = None):
        self.eng = eng
        self.bw = bw
        self.sched = sched
        self.share = {"line": line_share, "page": 1.0 - line_share}
        self.q: Dict[str, deque] = {"line": deque(), "page": deque()}
        self.head_rem: Dict[str, float] = {"line": 0.0, "page": 0.0}
        self.cb: Dict[str, Optional[Callable]] = {"line": None, "page": None}
        self.last = 0.0
        self.epoch = 0
        self.bytes = 0.0

    def _bw_at(self, t: float) -> float:
        s = self.sched
        return self.bw * s.bw_mult(t) if s is not None and s.bw_active else self.bw

    def _rates(self, t: float) -> Dict[str, float]:
        la = self.head_rem["line"] > 0
        pa = self.head_rem["page"] > 0
        if not (la or pa):
            return {"line": 0.0, "page": 0.0}
        lr, pr = class_share_split(1 if la else 0, 1 if pa else 0,
                                   self._bw_at(t), self.share["line"])
        return {"line": lr, "page": pr}

    def _advance(self, t: float):
        sched = self.sched
        varying = sched is not None and sched.bw_active
        if self.head_rem["line"] <= 0 and self.head_rem["page"] <= 0:
            self.last = max(self.last, t)  # idle link: skip epoch walking
            return
        while self.last < t:
            seg_end = min(t, sched.next_boundary(self.last)) if varying else t
            dt = seg_end - self.last
            if dt > 0:
                rates = self._rates(self.last)
                for c in ("line", "page"):
                    if self.head_rem[c] > 0:
                        self.head_rem[c] = max(0.0, self.head_rem[c] - rates[c] * dt)
            self.last = seg_end

    def _schedule(self, t: float):
        self.epoch += 1
        epoch = self.epoch
        rates = self._rates(t)
        best = None
        for c in ("line", "page"):
            if self.head_rem[c] > 0 and rates[c] > 0:
                eta = t + self.head_rem[c] / rates[c]
                if best is None or eta < best[0]:
                    best = (eta, c)
        if best is None:
            return
        eta, c = best
        # ETAs computed with this epoch's rate are invalid past the next
        # bandwidth-schedule boundary: fire there instead and re-derive the
        # rates (the fire handler reschedules any unfinished head).
        if self.sched is not None and self.sched.bw_active:
            nb = self.sched.next_boundary(t)
            if eta > nb:
                eta = nb

        def fire(tt: float, _c=c, _epoch=epoch):
            if _epoch != self.epoch:
                return  # stale
            self._advance(tt)
            # epsilon is in *bytes*: float residue from rate*dt rounding can
            # exceed 1e-9 while eta rounds to the same timestamp (no progress,
            # infinite event storm).  1e-3 bytes is far below any packet size.
            if self.head_rem[_c] > 1e-3:
                self._schedule(tt)
                return
            cb = self.cb[_c]
            self._pop_next(_c)
            self._schedule(tt)
            if cb:
                cb(tt)

        self.eng.at(eta, fire)

    def _pop_next(self, c: str):
        if self.q[c]:
            size, cb = self.q[c].popleft()
            self.head_rem[c] = size
            self.cb[c] = cb
        else:
            self.head_rem[c] = 0.0
            self.cb[c] = None

    def _flush(self, t: float):
        """Complete any head that already drained to zero during _advance —
        its scheduled fire event may be stale and must not drop the callback."""
        for c in ("line", "page"):
            while self.cb[c] is not None and self.head_rem[c] <= 1e-3:
                cb = self.cb[c]
                self._pop_next(c)
                cb(t)

    def send(self, t: float, size: float, cb: Callable[[float], None],
             cls: str = "line", flow: int = 0):
        self._advance(t)
        self._flush(t)
        self.bytes += size
        if self.cb[cls] is not None:
            self.q[cls].append((size, cb))
        else:
            self.head_rem[cls] = size
            self.cb[cls] = cb
        self._schedule(t)

    def backlog(self, t: float) -> float:
        """Outstanding bytes across both classes (congestion signal,
        DESIGN.md §2.7).  ``head_rem`` is exact as of the last ``_advance``;
        staleness only overstates the backlog, which is safe for a trigger."""
        q = sum(sz for d in self.q.values() for sz, _ in d)
        return q + sum(max(0.0, r) for r in self.head_rem.values())


class SharedLink:
    """Multi-flow generalization of :class:`DualQueueLink`'s fluid machinery
    (DESIGN.md §2.5): one FIFO *lane* per channel (a channel is a CC flow,
    or a (flow, class) pair), and an arbitration policy — ``_split`` — that
    divides the instantaneous link bandwidth across the backlogged lanes.
    Within a lane transfers serialize FIFO; across lanes the fluid shares
    are re-derived whenever a head completes, a send arrives, or a
    bandwidth-schedule epoch boundary passes.

    Only instantiated for ``n_ccs > 1`` systems: single-CC runs keep the
    legacy FifoLink/DualQueueLink code paths byte-for-byte.
    """

    def __init__(self, eng: Engine, bw: float, channels: Sequence[Hashable],
                 sched: Optional[LinkSchedule] = None):
        self.eng = eng
        self.bw = bw
        self.sched = sched
        self.channels: Tuple[Hashable, ...] = tuple(channels)
        self.q: Dict[Hashable, deque] = {c: deque() for c in self.channels}
        self.head_rem: Dict[Hashable, float] = dict.fromkeys(self.channels, 0.0)
        self.cb: Dict[Hashable, Optional[Callable]] = dict.fromkeys(self.channels)
        self.last = 0.0
        self.epoch = 0
        self.bytes = 0.0

    # -- arbitration policy (subclasses) --
    def _chan(self, flow: int, cls: str) -> Hashable:
        raise NotImplementedError

    def _split(self, active: List[Hashable], bw: float) -> Dict[Hashable, float]:
        """Divide ``bw`` across the backlogged channels ``active``."""
        raise NotImplementedError

    # -- fluid machinery (generalized from DualQueueLink) --
    def _bw_at(self, t: float) -> float:
        s = self.sched
        return self.bw * s.bw_mult(t) if s is not None and s.bw_active else self.bw

    def _rates(self, t: float) -> Dict[Hashable, float]:
        active = [c for c in self.channels if self.head_rem[c] > 0]
        rates = dict.fromkeys(self.channels, 0.0)
        if active:
            rates.update(self._split(active, self._bw_at(t)))
        return rates

    def _advance(self, t: float):
        sched = self.sched
        varying = sched is not None and sched.bw_active
        if all(self.head_rem[c] <= 0 for c in self.channels):
            self.last = max(self.last, t)  # idle link: skip epoch walking
            return
        while self.last < t:
            seg_end = min(t, sched.next_boundary(self.last)) if varying else t
            dt = seg_end - self.last
            if dt > 0:
                rates = self._rates(self.last)
                for c in self.channels:
                    if self.head_rem[c] > 0:
                        self.head_rem[c] = max(0.0, self.head_rem[c] - rates[c] * dt)
            self.last = seg_end

    def _schedule(self, t: float):
        self.epoch += 1
        epoch = self.epoch
        rates = self._rates(t)
        best = None
        for c in self.channels:
            if self.head_rem[c] > 0 and rates[c] > 0:
                eta = t + self.head_rem[c] / rates[c]
                if best is None or eta < best[0]:
                    best = (eta, c)
        if best is None:
            return
        eta, c = best
        if self.sched is not None and self.sched.bw_active:
            nb = self.sched.next_boundary(t)
            if eta > nb:
                eta = nb  # re-derive rates at the epoch boundary

        def fire(tt: float, _c=c, _epoch=epoch):
            if _epoch != self.epoch:
                return  # stale
            self._advance(tt)
            if self.head_rem[_c] > 1e-3:  # epsilon in bytes, as DualQueueLink
                self._schedule(tt)
                return
            # several lanes can drain at the same instant under fair shares:
            # complete every finished head, not just the scheduled one
            done = []
            for ch in self.channels:
                if self.cb[ch] is not None and self.head_rem[ch] <= 1e-3:
                    done.append(self.cb[ch])
                    self._pop_next(ch)
            self._schedule(tt)
            for fn in done:
                fn(tt)

        self.eng.at(eta, fire)

    def _pop_next(self, c: Hashable):
        if self.q[c]:
            size, cb = self.q[c].popleft()
            self.head_rem[c] = size
            self.cb[c] = cb
        else:
            self.head_rem[c] = 0.0
            self.cb[c] = None

    def _flush(self, t: float):
        for c in self.channels:
            while self.cb[c] is not None and self.head_rem[c] <= 1e-3:
                cb = self.cb[c]
                self._pop_next(c)
                cb(t)

    def send(self, t: float, size: float, cb: Callable[[float], None],
             cls: str = "line", flow: int = 0):
        self._advance(t)
        self._flush(t)
        self.bytes += size
        c = self._chan(flow, cls)
        if self.cb[c] is not None:
            self.q[c].append((size, cb))
        else:
            self.head_rem[c] = size
            self.cb[c] = cb
        self._schedule(t)

    def backlog(self, t: float) -> float:
        """Outstanding bytes across all lanes (congestion signal, §2.7)."""
        q = sum(sz for d in self.q.values() for sz, _ in d)
        return q + sum(max(0.0, r) for r in self.head_rem.values())


class SharedFifoLink(SharedLink):
    """Baseline MC downlink shared by ``n_flows`` CCs: one store-and-forward
    FIFO lane per CC, fluid fair share across backlogged lanes (k active
    flows each drain at bw/k — the fluid limit of round-robin packet
    arbitration).  Lines still serialize behind pages *within* a CC's lane
    (the paper's single-flow pathology), and a page burst from one CC
    additionally cuts every other CC's drain rate — the multi-CC contention
    the paper's scalability goal targets."""

    def __init__(self, eng: Engine, bw: float, n_flows: int,
                 sched: Optional[LinkSchedule] = None):
        super().__init__(eng, bw, tuple(range(n_flows)), sched)

    def _chan(self, flow: int, cls: str) -> Hashable:
        return flow

    def _split(self, active: List[Hashable], bw: float) -> Dict[Hashable, float]:
        r = fair_split(len(active), bw)
        return {c: r for c in active}


class SharedDualQueueLink(SharedLink):
    """DaeMon MC downlink shared by ``n_flows`` CCs: the line *class* keeps
    its fixed ``line_share`` of the bandwidth whenever any CC has a line in
    flight (the paper's fixed-rate queue controller, applied system-wide),
    and within each class the backlogged CC flows share the class bandwidth
    equally.  One CC's page burst therefore cannot delay another CC's
    critical lines beyond the fair division of the reserved line share."""

    def __init__(self, eng: Engine, bw: float, line_share: float, n_flows: int,
                 sched: Optional[LinkSchedule] = None):
        self.line_share = line_share
        channels = [(f, c) for f in range(n_flows) for c in ("line", "page")]
        super().__init__(eng, bw, channels, sched)

    def _chan(self, flow: int, cls: str) -> Hashable:
        return (flow, cls)

    def _split(self, active: List[Hashable], bw: float) -> Dict[Hashable, float]:
        lines = [c for c in active if c[1] == "line"]
        pages = [c for c in active if c[1] == "page"]
        lr, pr = class_share_split(len(lines), len(pages), bw, self.line_share)
        rates: Dict[Hashable, float] = {}
        for c in lines:
            rates[c] = lr
        for c in pages:
            rates[c] = pr
        return rates


class SharedHeteroLink(SharedLink):
    """Mixed-arbitration MC link for per-CC heterogeneous policies
    (DESIGN.md §2.9): a flow whose policy partitions the link gets a
    ``(flow, 'line')`` / ``(flow, 'page')`` lane pair; a FIFO flow gets one
    ``(flow, 'all')`` lane that counts as bulk.  When any dual flow has a
    line backlogged AND any bulk lane (a dual flow's pages, or a FIFO
    flow's whole queue) is backlogged, the line class keeps ``line_share``
    of the bandwidth; within a class backlogged lanes share equally.  A
    FIFO flow's lines therefore still serialize behind its own pages (the
    single-flow pathology), while dual flows keep the protected line class
    — per-CC policy choices keep their meaning on a shared fabric.  Only
    instantiated when CC policies actually disagree; homogeneous systems
    keep the legacy Shared{Fifo,DualQueue}Link bit-for-bit."""

    def __init__(self, eng: Engine, bw: float, line_share: float,
                 flow_dual: Sequence[bool],
                 sched: Optional[LinkSchedule] = None):
        self.line_share = line_share
        self.flow_dual = tuple(bool(d) for d in flow_dual)
        channels: List[Hashable] = []
        for f, dual in enumerate(self.flow_dual):
            if dual:
                channels += [(f, "line"), (f, "page")]
            else:
                channels.append((f, "all"))
        super().__init__(eng, bw, channels, sched)

    def _chan(self, flow: int, cls: str) -> Hashable:
        return (flow, cls) if self.flow_dual[flow] else (flow, "all")

    def _split(self, active: List[Hashable], bw: float) -> Dict[Hashable, float]:
        lines = [c for c in active if c[1] == "line"]
        bulk = [c for c in active if c[1] != "line"]
        lr, br = class_share_split(len(lines), len(bulk), bw, self.line_share)
        rates: Dict[Hashable, float] = {}
        for c in lines:
            rates[c] = lr
        for c in bulk:
            rates[c] = br
        return rates


# --------------------------------------------------------------------------
# link factories (shared by the flat model and the fabric ports)
# --------------------------------------------------------------------------


def _arb_maker(eng: Engine, kind: str, share: Optional[float], n_ccs: int,
               flow_dual: Optional[Tuple[bool, ...]] = None):
    """Link factory ``mk(bw, sched)`` for one arbitration kind.  Single-CC
    systems keep the legacy FifoLink/DualQueueLink classes (bit-identical);
    multi-CC systems share the link across per-CC flows."""
    if kind == "hetero":
        return lambda bw, s: SharedHeteroLink(eng, bw, share, flow_dual, s)
    if kind == "dual":
        if n_ccs == 1:
            return lambda bw, s: DualQueueLink(eng, bw, share, s)
        return lambda bw, s: SharedDualQueueLink(eng, bw, share, n_ccs, s)
    if n_ccs == 1:
        return lambda bw, s: FifoLink(eng, bw, s)
    return lambda bw, s: SharedFifoLink(eng, bw, n_ccs, s)


def _downlink_arb(pols, cfg: SimConfig):
    """Downlink arbitration from the CC policies' ``partitioning``
    components: homogeneous fifo/dual (dual flows must also agree on the
    resolved line share), else the per-flow hetero arbitration with the
    line class protected at the strictest (max) share among dual flows.
    Returns ``(kind, share, flow_dual)`` for :func:`_arb_maker`."""
    def share_of(p) -> float:
        return cfg.line_share if p.line_share is None else p.line_share

    parts = {p.partitioning for p in pols}
    shares = {share_of(p) for p in pols}
    if len(parts) == 1 and (parts == {"fifo"} or len(shares) == 1):
        kind = pols[0].partitioning
        return kind, (share_of(pols[0]) if kind == "dual" else None), None
    flow_dual = tuple(p.partitioning == "dual" for p in pols)
    share = max(share_of(p) for p in pols if p.partitioning == "dual")
    return "hetero", share, flow_dual


def _uplink_arb(pols, cfg: SimConfig):
    """Uplink arbitration from the policies' resolved ``uplink`` components
    ('line' class = request packets keeping ``1 - writeback_share``)."""
    req_share = 1.0 - cfg.writeback_share
    parts = {p.uplink_partitioning for p in pols}
    if len(parts) > 1:
        return "hetero", req_share, tuple(
            p.uplink_partitioning == "dual" for p in pols)
    return pols[0].uplink_partitioning, req_share, None


# --------------------------------------------------------------------------
# requests / CC state
# --------------------------------------------------------------------------


@dataclass
class Request:
    addr: int
    t_issue: float
    write: bool
    core: "Core"
    done: bool = False
    t_done: float = 0.0


@dataclass
class Core:
    cid: int
    gaps: np.ndarray
    addrs: np.ndarray
    writes: np.ndarray
    llc: LRU
    idx: int = 0
    t: float = 0.0
    outstanding: deque = field(default_factory=deque)
    stalled: bool = False
    t_end: float = -1.0
    cc: int = 0  # owning compute complex (index into Simulator.ccs)
    # serving layer (§2.9): the core issued its whole phase trace but still
    # has outstanding reads in flight; the last completion re-arms the
    # idle check instead of resuming issue
    draining: bool = False


@dataclass
class CCState:
    """One compute complex (DESIGN.md §2.5): its cores, its local page
    cache of remote memory, its own pending/inflight tracking (DaeMon's
    per-unit engines live per CC), and its own Metrics rollup.  Address
    spaces are per-CC (independent applications); CCs couple only through
    the shared per-MC downlinks."""

    idx: int
    workload: str
    cores: List[Core]
    local: LRU
    m: Metrics
    comp_base: float
    # this CC's MovementPolicy (per-CC heterogeneous systems, §2.9); always
    # set at construction — the same object as Simulator.policy on
    # homogeneous systems, so every dispatch site reads cc.policy
    policy: object = None
    # per-CC compression-ratio RNG: each CC's (de)compression engine samples
    # its own stream, so the draw count of one CC (or scheme) cannot perturb
    # another CC's ratios through global event order
    rng: Optional[np.random.Generator] = None
    # this CC's MovementController (§2.12): the selection/throttle/
    # compression decision state-machine; always set at construction
    # (resolve_controller: policy component > cfg.controller > 'fixed')
    ctrl: object = None
    pending_lines: Dict[int, List[Request]] = field(default_factory=dict)
    pending_pages: Dict[int, List[Request]] = field(default_factory=dict)
    retry: deque = field(default_factory=deque)


class Simulator:
    def __init__(
        self,
        cfg: SimConfig,
        scheme,
        traces,
        workload: str = "",
        seed: int = 0,
        footprints: Optional[Sequence[int]] = None,
    ):
        """``scheme`` is a registered policy name (str), a
        :class:`MovementPolicy` instance (need not be registered), or — for
        per-CC heterogeneous systems (§2.9) — a sequence of either with one
        entry per CC.  ``footprints`` (one per CC) overrides the
        trace-derived footprint; required when a CC starts with empty
        bootstrap traces (the serving layer assigns phases at run time)."""
        self.cfg = cfg
        if isinstance(scheme, (list, tuple)):
            self.policies: Optional[List] = [get_policy(s) for s in scheme]
            if len(self.policies) != max(1, cfg.n_ccs):
                raise ValueError(
                    f"n_ccs={cfg.n_ccs} but {len(self.policies)} per-CC "
                    f"policies given")
            self.policy = self.policies[0]
            names = [p.name for p in self.policies]
            self.scheme = names[0] if len(set(names)) == 1 else "|".join(names)
        else:
            self.policies = None
            self.policy = get_policy(scheme)
            self.scheme = self.policy.name
        self.workload = workload
        self.eng = Engine()
        self.m = Metrics(scheme=self.scheme, workload=workload)
        # memory-side resident state (§2.13): one pool shared by every CC.
        # None (legacy placement, no capacity) keeps the infinite-memory
        # expressions below untouched — committed goldens stay bit-true.
        self.mem = make_memside(cfg.n_mcs, cfg.mc_interleave,
                                cfg.mc_capacity_pages,
                                cfg.mem_hot_threshold, cfg.switch_lat)
        # serving hook (§2.9): called as on_core_idle(core, t) when a core
        # has issued its whole trace and its outstanding reads have drained
        self.on_core_idle: Optional[Callable[[Core, float], None]] = None

        # traces: List[Trace] (legacy, one CC) or List[List[Trace]] (one
        # group per CC).  A Trace is a tuple of ndarrays, so the first
        # element's first element disambiguates the two shapes.
        if traces and isinstance(traces[0][0], np.ndarray):
            cc_traces: List[List[Trace]] = [list(traces)]
        else:
            cc_traces = [list(g) for g in traces]
        if len(cc_traces) != max(1, cfg.n_ccs):
            raise ValueError(
                f"n_ccs={cfg.n_ccs} but {len(cc_traces)} trace group(s) given")
        if footprints is not None and len(footprints) != len(cc_traces):
            raise ValueError(
                f"n_ccs={cfg.n_ccs} but {len(footprints)} footprint(s) given")

        # per-CC workload assignment: 'pr' (all CCs) or a '+'-separated mix
        # ('pr+st') assigned round-robin across CCs
        parts = tuple(workload.split("+")) if workload else ("",)

        llc_lines = cfg.llc_bytes // cfg.line_bytes
        self.lines_per_page = cfg.page_bytes // cfg.line_bytes
        self.ccs: List[CCState] = []
        cid = itertools.count()
        for i, group in enumerate(cc_traces):
            w = parts[i % len(parts)]
            footprint = (int(footprints[i]) if footprints is not None
                         else int(max(int(tr[1].max()) + 64 for tr in group)))
            cores = [
                Core(next(cid), tr[0], tr[1] >> 6, tr[2],
                     LRU(llc_lines // max(1, len(group))), cc=i)
                for tr in group
            ]
            # local memory: page-granularity cache of remote memory
            n_pages_total = footprint // cfg.page_bytes + 1
            local = LRU(max(1, int(n_pages_total * cfg.local_mem_frac)))
            # the single-CC aggregate IS the CC's metrics (legacy identity);
            # multi-CC keeps per-CC metrics and rolls them up in run()
            m = self.m if len(cc_traces) == 1 else Metrics(scheme=self.scheme,
                                                           workload=w)
            # CC 0 keeps the legacy RNG stream (single-CC bit-parity); CC
            # i>0 gets an independent stream keyed by (seed, idx) so ratios
            # are a function of the CC's own draw count only
            pol = self.policies[i] if self.policies else self.policy
            self.ccs.append(CCState(
                idx=i, workload=w, cores=cores, local=local, m=m,
                comp_base=compressibility_of(w if len(parts) > 1 else workload),
                policy=pol,
                rng=(np.random.default_rng(seed + 17) if i == 0
                     else np.random.default_rng((seed + 17, i))),
                ctrl=make_controller(resolve_controller(pol, cfg), cfg,
                                     w if len(parts) > 1 else workload),
            ))
        self.cores = [c for cc in self.ccs for c in cc.cores]
        n_ccs = len(self.ccs)

        # per-MC variability schedules: seeded by (jitter_seed, mc) only, so
        # every scheme sees the same network weather (fair A/B comparison)
        self.scheds = [
            LinkSchedule(cfg.jitter_period, cfg.bw_jitter, cfg.lat_jitter,
                         seed=cfg.jitter_seed * 1000 + i)
            for i in range(cfg.n_mcs)
        ]
        # per-MC links (downlink data path; the request path is folded into
        # net_lat unless cfg.uplink_bw enables the explicit uplink below).
        # Single-CC systems keep the legacy link classes (bit-identical);
        # multi-CC systems share each MC downlink across per-CC flows.  The
        # policy's partitioning component picks the arbitration; when CC
        # policies disagree (heterogeneous partitioning, or dual flows with
        # different line shares) the SharedHeteroLink arbitrates per flow,
        # with the line class protected at the strictest (max) resolved
        # share among the dual flows.
        pols = self.policies if self.policies else [self.policy] * n_ccs
        dkind, dshare, dflow = _downlink_arb(pols, cfg)
        mk = _arb_maker(self.eng, dkind, dshare, n_ccs, dflow)
        # per-MC CC->MC uplinks (§2.7): request packets ('line' class) +
        # writeback bulk ('page' class), arbitrated per the policy's uplink
        # component; both directions see the same per-MC network weather.
        # uplink_bw=None keeps the legacy folded-into-net_lat model
        # bit-for-bit (no up links/ports exist at all).
        mku = None
        if cfg.uplink_bw is not None:
            ukind, ushare, uflow = _uplink_arb(pols, cfg)
            mku = _arb_maker(self.eng, ukind, ushare, n_ccs, uflow)

        if cfg.topology is None:
            # legacy flat model: one private link per MC and direction
            self.fabric = None
            self.links = [mk(cfg.link_bw, s) for s in self.scheds]
            self.uplinks = (None if mku is None else
                            [mku(cfg.uplink_bw, s) for s in self.scheds])
            self._req_hop_lat = [0.0] * cfg.n_mcs
        else:
            # routed fabric (§2.11): transfers cross explicit multi-hop
            # paths.  Endpoint NIC ports keep the policy's endpoint
            # arbitration (so 'direct' is the flat model, bit for bit);
            # switch-owned ports follow the policy 'fabric' component,
            # inheriting the direction's endpoint arbitration when unset —
            # daemon's dual-queue partitioning survives every hop while
            # FIFO baselines stay FIFO end-to-end.
            spec = build_topology(cfg.topology, n_ccs=n_ccs,
                                  n_mcs=cfg.n_mcs, oversub=cfg.oversub)
            fabs = {p.fabric for p in pols}
            fab = fabs.pop() if len(fabs) == 1 else None
            mk_sw = mk if fab is None else _arb_maker(
                self.eng, fab,
                dshare if dshare is not None else cfg.line_share, n_ccs)
            mku_sw = None
            if mku is not None:
                mku_sw = mku if fab is None else _arb_maker(
                    self.eng, fab, ushare, n_ccs)

            def port_link(p: PortSpec):
                bw = (cfg.link_bw if p.down else cfg.uplink_bw) * p.bw_frac
                sched = self.scheds[p.mc] if p.mc is not None else None
                f = ((mk_sw if p.switch else mk) if p.down
                     else (mku_sw if p.switch else mku))
                return f(bw, sched)

            self.fabric = Fabric(self.eng, spec, cfg.switch_lat, port_link,
                                 include_up=mku is not None)
            self.links = [self.fabric.down_route(j)
                          for j in range(cfg.n_mcs)]
            self.uplinks = (None if mku is None else
                            [self.fabric.up_route(j)
                             for j in range(cfg.n_mcs)])
            # folded request path (uplink_bw=None): the request packet
            # still crosses the up path's switches — charge their
            # store-and-forward processing as pure latency (0.0 on 1-hop
            # 'direct' paths, preserving flat-model identity)
            self._req_hop_lat = [float(cfg.switch_lat * self.fabric.up_hops(j))
                                 for j in range(cfg.n_mcs)]

    # ---------------- address helpers ----------------
    def page_of(self, line: int) -> int:
        return line // self.lines_per_page

    def mc_of(self, page: int) -> int:
        """Page -> MC link placement (DESIGN.md §2.3).  A page lives at one
        MC, so its page movement AND the line fetches into it share a link;
        distinct pages spread across independent links per the policy.
        Placement is per-CC-address-space: two CCs' page p land on the same
        MC — they contend for its downlink, not for the page itself.

        This is the legacy static map; with the memory-side state
        subsystem active (§2.13) the transfer paths resolve residency
        through ``self.mem`` instead (``touch`` at issue points,
        ``_mc_peek`` for controller observations)."""
        return mc_place(page, self.cfg.n_mcs, self.cfg.mc_interleave)

    def _mc_peek(self, cc: "CCState", page: int) -> int:
        """Pure resident-MC read for controller observations (§2.12:
        observation paths may be evaluated a different number of times
        per engine, so they must not mutate memside state)."""
        if self.mem is None:
            return self.mc_of(page)
        return self.mem.peek(cc.idx, page)

    def net_lat(self, mc: int, t: float) -> float:
        """One-way network latency on MC link ``mc`` at time ``t``."""
        return self.cfg.net_lat * self.scheds[mc].lat_mult(t)

    def comp_ratio(self, cc: CCState) -> float:
        base = cc.comp_base
        return max(1.0, cc.rng.normal(base, 0.15 * base))

    # ---------------- core execution ----------------
    def start(self):
        for c in self.cores:
            self.eng.at(0.0, lambda t, c=c: self.core_step(c, t))

    def core_step(self, core: Core, t: float):
        cfg = self.cfg
        cc = self.ccs[core.cc]
        core.stalled = False
        t = max(t, core.t)
        n = len(core.addrs)
        while core.idx < n:
            # retire completed requests from the in-order window
            while core.outstanding and core.outstanding[0].done:
                core.outstanding.popleft()
            if len(core.outstanding) >= cfg.mlp:
                core.stalled = True
                core.t = t
                cc.m.stall_episodes += 1  # one per mlp-window fill, not per cycle
                return  # resumed by completion of the oldest request
            line = int(core.addrs[core.idx])
            wr = bool(core.writes[core.idx])
            t += int(core.gaps[core.idx] * cfg.gap_scale)
            core.idx += 1
            cc.m.accesses += 1
            if core.llc.access(line, wr):
                cc.m.llc_hits += 1
                t += cfg.llc_lat
                continue
            t += cfg.llc_lat  # miss detection
            lat = self.miss(cc, core, line, wr, t)
            if lat is not None:  # served synchronously (local memory / 'local')
                t += lat
        core.t = t
        core.t_end = max(core.t_end, t)
        if self.on_core_idle is not None:
            self._maybe_idle(core, t)

    def _maybe_idle(self, core: Core, t: float):
        """Serving hook (§2.9): fire ``on_core_idle`` once per phase, after
        the core has issued its whole trace AND its outstanding reads have
        drained.  Write misses do not block idleness (write-release
        semantics: their fills land through the normal arrival paths).
        Safe against stale deferred events — a newly assigned phase resets
        ``idx`` and the guard below skips the fire."""
        if self.on_core_idle is None or core.idx < len(core.addrs):
            return
        while core.outstanding and core.outstanding[0].done:
            core.outstanding.popleft()
        if core.outstanding:
            core.draining = True  # _complete re-arms the check
            return
        core.draining = False
        t = max(t, core.t)
        core.t_end = max(core.t_end, t)
        self.on_core_idle(core, t)

    def _complete(self, req: Request, t: float):
        req.done = True
        req.t_done = t
        self.ccs[req.core.cc].m.miss_latency_sum += t - req.t_issue
        core = req.core
        if core.stalled and core.outstanding and core.outstanding[0].done:
            self.eng.at(t, lambda tt, c=core: self.core_step(c, tt))
        elif core.draining:
            core.draining = False
            self.eng.at(t, lambda tt, c=core: self._maybe_idle(c, tt))

    def _fill_line(self, core: Core, line: int, dirty: bool):
        core.llc.insert(line, dirty)

    def _insert_page(self, cc: CCState, page: int, t: float):
        ev = cc.local.insert(page)
        if ev is not None and ev[1]:  # dirty eviction -> writeback
            self._send_writeback(cc, ev[0], t)

    # ---------------- miss handling per policy ----------------
    def _local_hit(self, cc: CCState, core: Core, line: int, wr: bool, t: float) -> None:
        """DRAM access in local memory: async within the MLP window."""
        cc.m.local_hits += 1
        self._fill_line(core, line, wr)
        req = self._mk_req(core, line, wr, t)
        self.eng.at(t + self.cfg.mem_lat, lambda tt: self._complete(req, tt))

    def miss(self, cc: CCState, core: Core, line: int, wr: bool, t: float) -> Optional[float]:
        """LLC-miss path, dispatched on the policy's *components* (DESIGN.md
        §2.6) — never on policy names, so new registered compositions need
        no edits here.  The policy is the CC's own (per-CC heterogeneous
        systems, §2.9; the shared object on homogeneous ones)."""
        pol = cc.policy
        gran = pol.granularity
        page = self.page_of(line)

        if gran == "none":  # monolithic: every miss is local DRAM
            self._local_hit(cc, core, line, wr, t)
            return None

        if gran == "line":  # line movement only, no local-memory migration
            cc.m.remote_misses += 1
            req = self._mk_req(core, line, wr, t)
            self._fetch_line(cc, line, t, req)
            return None

        # page-moving policies check local memory first
        if cc.local.access(page, wr):
            self._local_hit(cc, core, line, wr, t)
            return None

        cc.m.remote_misses += 1

        if pol.free_transfers:  # idealized locality bound
            self._insert_page(cc, page, t)
            cc.m.pages_moved += 1
            cc.m.local_hits -= 1  # counted as remote, not a local hit
            self._local_hit(cc, core, line, wr, t)
            return None

        if gran == "page":  # requests ride the page migration
            req = self._mk_req(core, line, wr, t)
            if page in cc.pending_pages:
                cc.pending_pages[page].append(req)
            else:
                cc.pending_pages[page] = [req]
                self._send_page(cc, page, t)
            return None

        # 'both' / 'adaptive': decoupled multi-granularity movement
        return self._composed_miss(cc, core, line, wr, t)

    def _mk_req(self, core: Core, line: int, wr: bool, t: float) -> Request:
        req = Request(line, t, wr, core)
        if not wr:
            core.outstanding.append(req)
        return req

    # ---------------- transfers ----------------
    def _request_flight(self, cc: CCState, mc: int, t: float, extra: float,
                        then: Callable[[float], None]):
        """CC->MC request flight: run ``then`` when the request packet has
        reached MC ``mc`` and its DRAM read (+ ``extra``, e.g. compression
        pipeline fill) has completed.

        Legacy (``uplink_bw=None``): a pure latency — ``net_lat`` +
        ``remote_mem_lat`` — exactly the folded request path.  Uplink model
        (§2.7): the ~``header_bytes`` packet first queues on the contended
        CC->MC uplink's protected 'line' class, then flies."""
        cfg = self.cfg
        if self.uplinks is None:
            # _req_hop_lat charges switch store-and-forward on the folded
            # path (§2.11); 0.0 without a topology — adding it is then an
            # exact float identity, keeping the committed goldens bit-true
            self.eng.at(t + self.net_lat(mc, t) + cfg.remote_mem_lat + extra
                        + self._req_hop_lat[mc], then)
            return
        cc.m.uplink_bytes += cfg.header_bytes

        def on_up_done(tt: float):
            self.eng.at(tt + self.net_lat(mc, tt) + cfg.remote_mem_lat + extra,
                        then)

        self.uplinks[mc].send(t, cfg.header_bytes, on_up_done, "line", cc.idx)

    def _fetch_line(self, cc: CCState, line: int, t: float,
                    req: Optional[Request] = None):
        """Line fetch: request flight + MC read + downlink queue + flight."""
        cfg = self.cfg
        lst = cc.pending_lines.get(line)
        if lst is not None:  # coalesce with the inflight fetch
            if req is not None:
                lst.append(req)
            return
        cc.pending_lines[line] = [req] if req is not None else []
        cc.m.lines_moved += 1
        page = self.page_of(line)
        if self.mem is None:
            mc, xl = self.mc_of(page), 0.0
        else:  # §2.13: resolve residency (allocating on first touch); the
            # promotion signal is moot here — line-granularity policies
            # have no local page cache to promote into
            mc, xl, _ = self.mem.touch(cc.idx, page, "line")
        link = self.links[mc]
        size = cfg.line_bytes + cfg.header_bytes

        def on_tx_done(tt: float):
            arrive = tt + self.net_lat(mc, tt)
            self.eng.at(arrive, lambda a: self._on_line_arrival(cc, line, a))

        self._request_flight(
            cc, mc, t, xl,
            lambda tt: link.send(tt, size, on_tx_done, "line", cc.idx))
        cc.m.net_bytes += size

    def _send_page(self, cc: CCState, page: int, t: float):
        """Demand page migration MC->CC: request flight + MC read +
        downlink queue + flight (+ compression pipeline at either end)."""
        cfg = self.cfg
        if self.mem is None:
            mc, xl = self.mc_of(page), 0.0
        else:  # 'page' touch also resets the hotness count (§2.13): the
            # migration satisfies whatever promotion the tracker wanted
            mc, xl, _ = self.mem.touch(cc.idx, page, "page")
        link = self.links[mc]
        raw = cfg.page_bytes + cfg.header_bytes
        size = raw
        extra = 0.0
        # Link compression (paper §3-III): engaged when the controller
        # signals congestion (for 'fixed', the inflight page buffer past
        # PAGE_FAST — the bandwidth-bound regime).  The compressor is
        # streaming, so only the pipeline fill (~1/4 of the full pass)
        # sits on the critical path; the rest overlaps transmission.
        if (cc.policy.compression != "off" and cfg.compress
                and cc.ctrl.decide(self._obs(cc, mc, t)).compress):
            ratio = self.comp_ratio(cc)
            size = cfg.page_bytes / ratio + cfg.header_bytes
            extra = cfg.comp_lat / 4
            cc.m.bytes_saved_compression += raw - size
        cc.m.net_bytes += size
        cc.m.pages_moved += 1

        def on_tx_done(tt: float):
            arrive = tt + self.net_lat(mc, tt) + (cfg.decomp_lat / 4 if extra else 0.0)
            self.eng.at(arrive, lambda a: self._on_page_arrival(cc, page, a))

        # xl charges the spilled-resident detour (§2.13) on the request
        # path; decompression above stays keyed on `extra` alone
        self._request_flight(
            cc, mc, t, extra + xl,
            lambda tt: link.send(tt, size, on_tx_done, "page", cc.idx))

    def _send_writeback(self, cc: CCState, page: int, t: float):
        """Dirty-page eviction written back CC->MC.

        Legacy (``uplink_bw=None``): the reverse path is not modeled, so the
        writeback is injected into the *downlink* queue (stealing bandwidth
        from demand traffic) and counted as downlink bytes — preserved
        bit-for-bit for golden parity.  Uplink model (§2.7): the writeback
        queues on the CC->MC uplink's bulk 'page' class, counted as uplink
        bytes, and CC-side writeback compression keys off the *uplink
        backlog* (the congestion it actually contends with) instead of the
        downlink inflight-page-buffer signal."""
        cfg = self.cfg
        if self.mem is None:
            mc, xl = self.mc_of(page), 0.0
        else:  # 'wb' touch re-allocates a backing page the pool evicted
            mc, xl, _ = self.mem.touch(cc.idx, page, "wb")
        raw = cfg.page_bytes + cfg.header_bytes
        size = raw
        extra = 0.0
        cc.m.writebacks += 1
        compress = cc.policy.compression != "off" and cfg.compress
        if self.uplinks is None:
            link = self.links[mc]
            if compress and cc.ctrl.decide(self._obs(cc, mc, t)).compress:
                ratio = self.comp_ratio(cc)
                size = cfg.page_bytes / ratio + cfg.header_bytes
                extra = cfg.comp_lat / 4
                cc.m.bytes_saved_compression += raw - size
            cc.m.net_bytes += size
            # compressed at the CC, then "sent back" on the downlink; xl
            # charges the spilled-resident detour (§2.13)
            depart = t + extra + xl
            self.eng.at(depart,
                        lambda tt: link.send(tt, size, lambda a: None, "page", cc.idx))
            return
        up = self.uplinks[mc]
        lu, pu = self._buf_utils(cc)
        if compress and cc.ctrl.decide(
                Observation(t, lu, pu, up.backlog(t))).compress_writeback:
            ratio = self.comp_ratio(cc)
            size = cfg.page_bytes / ratio + cfg.header_bytes
            extra = cfg.comp_lat / 4
            cc.m.bytes_saved_compression += raw - size
        cc.m.uplink_bytes += size
        self.eng.at(t + extra + xl,
                    lambda tt: up.send(tt, size, lambda a: None, "page", cc.idx))

    # ---------------- arrivals ----------------
    def _on_line_arrival(self, cc: CCState, line: int, t: float):
        cc.ctrl.observe_line(t)
        reqs = cc.pending_lines.pop(line, [])
        for r in reqs:
            if not r.done:
                self._fill_line(r.core, line, r.write)
                self._complete(r, t)
        self._drain_retry(cc, t)

    def _on_page_arrival(self, cc: CCState, page: int, t: float):
        cc.ctrl.observe_page(t)
        self._insert_page(cc, page, t)
        reqs = cc.pending_pages.pop(page, [])
        for r in reqs:
            if not r.done:
                self._fill_line(r.core, r.addr, r.write)
                self._complete(r, t + self.cfg.mem_lat)  # read from local memory
        self._drain_retry(cc, t)

    # ---------------- decoupled multi-granularity movement ----------------
    def _buf_utils(self, cc: CCState) -> Tuple[float, float]:
        lu = len(cc.pending_lines) / self.cfg.inflight_lines
        pu = len(cc.pending_pages) / self.cfg.inflight_pages
        return lu, pu

    def _obs(self, cc: CCState, mc: int, t: float) -> Observation:
        """The controller's observation vector at a decision point.  The
        uplink backlog (toward MC ``mc``) is computed only for controllers
        that declare ``needs_uplink`` — a link-heap scan stays off the
        miss hot path under the default 'fixed' controller."""
        lu, pu = self._buf_utils(cc)
        ub = 0.0
        if cc.ctrl.needs_uplink and self.uplinks is not None:
            ub = self.uplinks[mc].backlog(t)
        return Observation(t, lu, pu, ub)

    def _composed_miss(self, cc: CCState, core: Core, line: int, wr: bool,
                       t: float) -> Optional[float]:
        """'both'/'adaptive' granularity: issue line and page movements for a
        triggering miss; requests complete on whichever arrives first.

        The per-CC MovementController (§2.12) makes the decisions.  With
        ``granularity='adaptive'`` its selection unit (paper §3-II)
        modulates racing from the observation vector: under 'fixed', when
        the page buffer drains fast (compressed pages, page-friendly
        phase) redundant line races on coalesced misses are skipped; when
        it backs up (low locality), coalesced misses race lines on the
        critical path.  With ``throttle`` the controller gates issue
        (under 'fixed': pages stop above ``page_throttle_hi``; full
        buffers park the request in the retry queue).
        ``page_carries_requests=False`` is the legacy 'both' race: the
        line always carries the request, the page is pure prefetch."""
        pol = cc.policy
        adaptive = pol.granularity == "adaptive"
        page = self.page_of(line)
        req = self._mk_req(core, line, wr, t)
        coalesced = page in cc.pending_pages
        cc.ctrl.observe_miss(coalesced)
        d = cc.ctrl.decide(self._obs(cc, self._mc_peek(cc, page), t))

        # coalesce with an inflight page migration (the page is already
        # moving, so the line fetch's promotion signal is moot)
        if coalesced:
            if pol.page_carries_requests:
                cc.pending_pages[page].append(req)
            if line in cc.pending_lines:
                cc.pending_lines[line].append(req)
            elif adaptive:
                if d.race_line:
                    cc.pending_lines[line] = [req]
                    self._fetch_line_daemon(cc, line, t, req)
            elif not pol.page_carries_requests:
                cc.pending_lines[line] = [req]
                self._fetch_line_daemon(cc, line, t, req)
            return None

        # triggering miss: BOTH by default — the line hides page queueing and
        # (de)compression latency, costing only ~80B next to a ~2KB page
        if pol.throttle:
            issue_page = d.issue_page
            issue_line = d.issue_line or line in cc.pending_lines
            if not issue_line and not issue_page:
                cc.retry.append(req)  # buffers full: re-issue when one drains
                return None
        else:
            issue_page = issue_line = True

        promote = False
        if issue_line:
            if line in cc.pending_lines:
                cc.pending_lines[line].append(req)
            else:
                cc.pending_lines[line] = [req]
                promote = self._fetch_line_daemon(cc, line, t, req)
        if issue_page:
            waiting = cc.pending_pages.setdefault(page, [])
            if pol.page_carries_requests:
                waiting.append(req)
            self._send_page(cc, page, t)
        # after the issue_page block: a demand migration just issued for
        # this page makes the promotion redundant (guarded inside)
        if promote:
            self._maybe_promote(cc, page, t)
        return None

    def _fetch_line_daemon(self, cc: CCState, line: int, t: float,
                           req: Request) -> bool:
        """Returns the hot-page promotion signal (§2.13) so callers can
        act on it *after* their page-issue bookkeeping settles."""
        cfg = self.cfg
        cc.m.lines_moved += 1
        page = self.page_of(line)
        if self.mem is None:
            mc, xl, promote = self.mc_of(page), 0.0, False
        else:
            mc, xl, promote = self.mem.touch(cc.idx, page, "line")
        link = self.links[mc]
        size = cfg.line_bytes + cfg.header_bytes
        cc.m.net_bytes += size

        def on_tx_done(tt: float):
            arrive = tt + self.net_lat(mc, tt)
            self.eng.at(arrive, lambda a: self._on_line_arrival(cc, line, a))

        self._request_flight(
            cc, mc, t, xl,
            lambda tt: link.send(tt, size, on_tx_done, "line", cc.idx))
        return promote

    def _maybe_promote(self, cc: CCState, page: int, t: float):
        """Hot-page promotion (§2.13): the access-frequency tracker says
        this still-remote page keeps absorbing line fetches — migrate it
        toward the owning CC's page cache, waiterless (later misses
        coalesce onto the inflight entry; the insert's dirty eviction
        rides the normal writeback path).  Throttled by the controller's
        backlog signal: the same inflight-page-buffer utilization the
        Observation carries, bounded at full (pu < 1.0) rather than at
        ``page_throttle_hi`` — hotness accumulates precisely in the
        throttled regime where demand migration stopped, so promotion
        runs there and only yields when the buffer is truly full."""
        if page in cc.pending_pages or page in cc.local:
            return
        if len(cc.pending_pages) >= self.cfg.inflight_pages:
            return
        self.mem.promotions += 1
        cc.pending_pages[page] = []
        self._send_page(cc, page, t)

    def _drain_retry(self, cc: CCState, t: float):
        n = len(cc.retry)
        for _ in range(n):
            req = cc.retry.popleft()
            if req.done:
                continue
            line = req.addr
            page = self.page_of(line)
            d = cc.ctrl.decide(self._obs(cc, self._mc_peek(cc, page), t))
            if line in cc.pending_lines:
                cc.pending_lines[line].append(req)
            elif page in cc.pending_pages:
                cc.pending_pages[page].append(req)
            elif d.issue_line:
                cc.pending_lines[line] = [req]
                if self._fetch_line_daemon(cc, line, t, req):
                    self._maybe_promote(cc, page, t)
            elif d.issue_page:
                cc.pending_pages[page] = [req]
                self._send_page(cc, page, t)
            else:
                cc.retry.append(req)

    # ---------------- run ----------------
    def run(self, until: Optional[float] = None) -> Metrics:
        self.start()
        self.eng.run(until=until)
        for cc in self.ccs:
            cc.m.cycles = max(c.t_end for c in cc.cores)
        if len(self.ccs) == 1:
            self._memside_rollup(self.m)
            return self.m  # the aggregate IS the single CC's metrics
        # aggregate rollup (§2.5): counters sum in CC order, end-to-end
        # cycles is the makespan, and per_cc keeps the full per-CC split
        m = self.m
        for cc in self.ccs:
            m.accesses += cc.m.accesses
            m.llc_hits += cc.m.llc_hits
            m.local_hits += cc.m.local_hits
            m.remote_misses += cc.m.remote_misses
            m.miss_latency_sum += cc.m.miss_latency_sum
            m.net_bytes += cc.m.net_bytes
            m.uplink_bytes += cc.m.uplink_bytes
            m.pages_moved += cc.m.pages_moved
            m.lines_moved += cc.m.lines_moved
            m.writebacks += cc.m.writebacks
            m.bytes_saved_compression += cc.m.bytes_saved_compression
            m.stall_episodes += cc.m.stall_episodes
            d = cc.m.as_dict()
            d.pop("per_cc")
            d["cc"] = cc.idx
            m.per_cc.append(d)
        m.cycles = max(cc.m.cycles for cc in self.ccs)
        self._memside_rollup(m)
        return m

    def _memside_rollup(self, m: Metrics):
        """Copy the cell-global §2.13 pool counters into the aggregate
        (the pool is shared across CCs — per_cc entries keep zeros)."""
        if self.mem is not None:
            m.mc_spills = self.mem.spills
            m.mc_evictions = self.mem.evictions
            m.mc_promotions = self.mem.promotions


def simulate(
    cfg: SimConfig, scheme, traces, workload: str = "", seed: int = 0
) -> Metrics:
    """Run one simulation.  ``scheme`` is a registered policy name or a
    :class:`MovementPolicy`; ``traces`` is a flat ``List[Trace]`` for the
    single-CC model or a ``List[List[Trace]]`` with one group per CC
    (``len == cfg.n_ccs``); ``workload`` may be a '+'-separated mix assigned
    round-robin across CCs."""
    return Simulator(cfg, scheme, traces, workload, seed).run()
