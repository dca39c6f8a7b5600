"""Batch simulation core: many independent sweep cells advanced in lockstep.

The Python event engine in :mod:`engine` is the *oracle*: every behaviour is
defined there.  This module re-implements the covered subset as a flat,
monomorphized event loop so that one process can advance a whole *batch* of
sweep cells — sharing prepared traces, jitter-schedule caches, and the
interpreter's warm state across cells — at a fraction of the oracle's cost.
It is a transcription, not a reformulation: every arithmetic expression goes
through the same pure helpers (`fifo_finish`, `class_share_split`,
`mc_place`, `selection_races_line` in :mod:`engine`) or
repeats the oracle's float expression shape verbatim, and every event the
oracle enqueues maps 1:1 (same timestamp, same sequence number) to an event
here.  The contract — enforced by tests/test_engine_batch.py — is
**cell-for-cell bit-identical metrics** against the oracle.

Where the speed comes from (DESIGN.md §2.10):

- events are plain tuples ``(t, seq, kind, a, b)`` dispatched by one flat
  loop instead of per-event closures, with the core-step / completion /
  arrival handlers (and their LRU touch points, as raw OrderedDict
  operations) inlined at the dispatch arms;
- the oracle's no-op writeback transmit-completion callback is elided
  instead of enqueued: dropping a push/pop pair whose handler has no
  effect renumbers the remaining sequence numbers monotonically, so every
  relative (t, seq) comparison — hence the pop order — is preserved;
- traces are prepared once per ``(workload, seed, footprint, n, gap_scale)``
  signature — pre-scaled gap lists, pre-shifted line lists — and shared by
  every cell in the batch that replays them (the fig2 grid replays each
  trace once per scheme);
- jitter schedules are shared per ``(period, jitter, seed)`` so the
  per-epoch multiplier cache is computed once for the whole batch;
- link lanes are lists indexed by channel number, not dicts keyed by
  ``(flow, class)`` tuples;
- per-cell cursors/backlogs/counters live in struct-of-arrays numpy views
  (:class:`BatchState`), synced at lockstep-quantum boundaries, so the
  driver can observe and report progress across the batch without touching
  the hot loop.

Coverage: everything :func:`repro_torch.core.sim.sweep.run_one` can express
*except* the request-level serving layer (``cfg.serving_router``),
routed fabric topologies (``cfg.topology``), and per-CC heterogeneous
policy lists.  :func:`covers` is the dispatch predicate; uncovered cells
fall back to the oracle in ``run_sweep``.
"""
from __future__ import annotations

import gc
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from heapq import heappop, heappush
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.sim.config import Metrics, SimConfig
from repro_torch.core.sim.controller import (
    Observation,
    make_controller,
    resolve_controller,
)
from repro_torch.core.sim.engine import (
    PAGE_FAST,
    LinkSchedule,
    class_share_split,
    fifo_finish,
    mc_place,
    selection_races_line,
)
from repro_torch.core.sim.memside import make_memside
from repro_torch.core.sim.policy import MovementPolicy, get_policy
from repro_torch.core.sim.trace import compressibility_of, generate

# event kinds (tuple field 2); dispatch order in _Frame.advance roughly
# tracks frequency on the quick grids
K_CORE = 0       # a = global core index
K_COMPLETE = 1   # a = request record
K_FLIGHT = 2     # a = link, b = (size, clsidx, flow, cbdesc): deferred send
K_TXDONE = 3     # a = cbdesc (FIFO link transmit completion)
K_FIRE = 4       # a = link, b = (channel, epoch) (fluid-link head ETA)
K_LINE_ARR = 5   # a = cc index, b = line
K_PAGE_ARR = 6   # a = cc index, b = page
K_WBSEND = 7     # a = link, b = (size, flow): delayed writeback injection

# request records are plain lists: [addr, t_issue, write, core_k, done]
R_ADDR, R_TISSUE, R_WR, R_CORE, R_DONE = range(5)

# callback descriptors (cbdesc): what the oracle captures in its closures.
# ("line", cc, line, mc) / ("page", cc, page, mc, has_decomp) are the
# downlink on_tx_done callbacks; ("up", mc, extra, link, size, clsidx, cc,
# inner) is the uplink on_up_done; NOP is the oracle's `lambda a: None`
# writeback callback (it still occupies a lane / consumes a seq number).
NOP = ("nop",)

CLS_LINE, CLS_PAGE = 0, 1


def uncovered_reason(cfg: SimConfig, scheme: Any) -> Optional[str]:
    """Why the batch core cannot reproduce this cell bit-for-bit, naming
    the config field responsible (actionable fallback diagnostics), or
    ``None`` when the cell is covered."""
    if isinstance(scheme, (list, tuple)):
        return ("scheme is a per-CC heterogeneous policy list "
                "(SharedHeteroLink arbitration, §2.9)")
    if cfg.serving_router is not None:
        return (f"serving_router={cfg.serving_router!r} enables the "
                f"request-level serving layer (§2.9)")
    if cfg.topology is not None:
        return (f"topology={cfg.topology!r} routes transfers over a "
                f"multi-hop fabric (§2.11)")
    return None


def covers(cfg: SimConfig, scheme: Any) -> bool:
    """True when the batch core reproduces this cell bit-for-bit; False
    routes the cell to the oracle (automatic fallback in run_sweep).
    Memory-side state cells (§2.13: mc_capacity_pages set and/or a
    non-legacy mc_interleave placement) ARE covered — both engines drive
    the same MemsideState at the same event points."""
    return uncovered_reason(cfg, scheme) is None


# --------------------------------------------------------------------------
# shared pools: prepared traces + jitter schedules
# --------------------------------------------------------------------------


class TracePool:
    """Prepared traces shared across a batch, keyed by trace-shape signature
    ``(workload, seed, footprint, n, gap_scale)``.  A prepared trace is
    ``(gaps, lines, writes, raw_max)`` where ``gaps`` is the pre-scaled
    integer gap list (``int(gap * gap_scale)`` elementwise — the oracle's
    per-access expression), ``lines`` the pre-shifted ``addr >> 6`` list,
    and ``raw_max`` the max raw address (the oracle's footprint input)."""

    def __init__(self):
        self._d: Dict[tuple, tuple] = {}

    def get(self, workload: str, seed: int, footprint: int, n: int,
            gap_scale: float) -> tuple:
        key = (workload, seed, footprint, n, gap_scale)
        prep = self._d.get(key)
        if prep is None:
            gaps, addrs, writes = generate(workload, seed=seed,
                                           footprint=footprint, n=n)
            prep = self._d[key] = (
                (gaps * gap_scale).astype(np.int64).tolist(),
                (addrs >> 6).tolist(),
                writes.tolist(),
                int(addrs.max()),
            )
        return prep


class SchedPool:
    """LinkSchedules shared across a batch, keyed by their defining tuple.
    Multipliers are a pure function of (seed, epoch), so sharing the
    schedule object shares its epoch cache — the piecewise jitter
    integration is computed once per epoch for every cell in the batch."""

    def __init__(self):
        self._d: Dict[tuple, LinkSchedule] = {}

    def get(self, period: int, bw_jitter: float, lat_jitter: float,
            seed: int) -> LinkSchedule:
        key = (period, bw_jitter, lat_jitter, seed)
        s = self._d.get(key)
        if s is None:
            s = self._d[key] = LinkSchedule(period, bw_jitter, lat_jitter,
                                            seed=seed)
        return s


# --------------------------------------------------------------------------
# link lanes (monomorphized transcriptions of engine.py's link classes)
# --------------------------------------------------------------------------


class _BFifo:
    """FifoLink: one store-and-forward queue (busy-until scalar)."""

    __slots__ = ("bw", "sched", "busy", "nbytes")

    def __init__(self, bw: float, sched: Optional[LinkSchedule]):
        self.bw = bw
        # an inert schedule (bw_jitter == 0) behaves exactly like None in
        # fifo_finish; dropping it here just skips the property check
        self.sched = sched if (sched is not None and sched.bw_active) else None
        self.busy = 0.0
        self.nbytes = 0.0

    def send(self, fr: "_Frame", t: float, size, cbdesc, clsidx: int,
             flow: int):
        busy = self.busy
        start = t if t > busy else busy  # max(t, busy_until)
        sched = self.sched
        if sched is None:
            done = start + size / self.bw  # fifo_finish's inert-schedule arm
        else:
            done = fifo_finish(start, size, self.bw, sched)
        self.busy = done
        self.nbytes += size
        if cbdesc is not NOP:
            s = fr.seq
            heappush(fr.heap, (done, s, K_TXDONE, cbdesc, 0))
            fr.seq = s + 1
        # NOP (the oracle's `lambda a: None` writeback callback) is elided:
        # its handler has no effect, and dropping a push/pop pair renumbers
        # the remaining sequence numbers monotonically, so every relative
        # (t, seq) comparison — hence every pop order — is preserved.

    def backlog(self, t: float) -> float:
        d = self.busy - t
        return (d if d > 0.0 else 0.0) * self.bw


class _BDual:
    """DualQueueLink: fluid line/page classes, single flow."""

    __slots__ = ("bw", "ls", "ps", "sched", "hl", "hp", "cl", "cp",
                 "ql", "qp", "last", "epoch", "nbytes")

    def __init__(self, bw: float, line_share: float,
                 sched: Optional[LinkSchedule]):
        self.bw = bw
        self.ls = line_share
        self.ps = 1.0 - line_share  # precomputed at init, as the oracle does
        self.sched = sched if (sched is not None and sched.bw_active) else None
        self.hl = 0.0
        self.hp = 0.0
        self.cl: Optional[tuple] = None
        self.cp: Optional[tuple] = None
        self.ql: deque = deque()
        self.qp: deque = deque()
        self.last = 0.0
        self.epoch = 0
        self.nbytes = 0.0

    def _advance(self, t: float):
        hl = self.hl
        hp = self.hp
        if hl <= 0 and hp <= 0:
            if t > self.last:
                self.last = t  # idle link: skip epoch walking
            return
        sched = self.sched
        if sched is None:
            last = self.last
            if last < t:
                dt = t - last
                bw = self.bw
                if hl > 0:
                    r = self.ls * bw if hp > 0 else bw
                    v = hl - r * dt
                    self.hl = v if v > 0.0 else 0.0
                if hp > 0:
                    r = self.ps * bw if hl > 0 else bw
                    v = hp - r * dt
                    self.hp = v if v > 0.0 else 0.0
                self.last = t
            return
        last = self.last
        while last < t:
            nb = sched.next_boundary(last)
            seg = t if t < nb else nb  # min(t, next_boundary)
            dt = seg - last
            if dt > 0:
                bw = self.bw * sched.bw_mult(last)
                hl = self.hl
                hp = self.hp
                if hl > 0:
                    r = self.ls * bw if hp > 0 else bw
                    v = hl - r * dt
                    self.hl = v if v > 0.0 else 0.0
                if hp > 0:
                    r = self.ps * bw if hl > 0 else bw
                    v = hp - r * dt
                    self.hp = v if v > 0.0 else 0.0
            last = seg
        self.last = last

    def _schedule(self, fr: "_Frame", t: float):
        self.epoch += 1
        hl = self.hl
        hp = self.hp
        if hl <= 0 and hp <= 0:
            return
        sched = self.sched
        bw = self.bw * sched.bw_mult(t) if sched is not None else self.bw
        if hl > 0:
            rl = self.ls * bw if hp > 0 else bw
        else:
            rl = 0.0
        if hp > 0:
            rp = self.ps * bw if hl > 0 else bw
        else:
            rp = 0.0
        # candidate order line-then-page with strict < tiebreak, as oracle
        eta = None
        c = CLS_LINE
        if hl > 0 and rl > 0:
            eta = t + hl / rl
        if hp > 0 and rp > 0:
            e2 = t + hp / rp
            if eta is None or e2 < eta:
                eta = e2
                c = CLS_PAGE
        if eta is None:
            return
        if sched is not None:
            nb = sched.next_boundary(t)
            if eta > nb:
                eta = nb  # re-derive rates at the epoch boundary
        s = fr.seq
        heappush(fr.heap, (eta, s, K_FIRE, self, (c, self.epoch)))
        fr.seq = s + 1

    def fire(self, fr: "_Frame", tt: float, c: int, epoch: int):
        if epoch != self.epoch:
            return  # stale
        self._advance(tt)
        # epsilon in *bytes*, exactly the oracle's storm guard
        if (self.hl if c == CLS_LINE else self.hp) > 1e-3:
            self._schedule(fr, tt)
            return
        if c == CLS_LINE:
            cb = self.cl
            self._pop_l()
        else:
            cb = self.cp
            self._pop_p()
        self._schedule(fr, tt)
        if cb is not None:
            fr._run_cb(cb, tt)  # NOP lane heads fall through (no arrival)

    def _pop_l(self):
        q = self.ql
        if q:
            size, cb = q.popleft()
            self.hl = size
            self.cl = cb
        else:
            self.hl = 0.0
            self.cl = None

    def _pop_p(self):
        q = self.qp
        if q:
            size, cb = q.popleft()
            self.hp = size
            self.cp = cb
        else:
            self.hp = 0.0
            self.cp = None

    def _flush(self, fr: "_Frame", t: float):
        while self.cl is not None and self.hl <= 1e-3:
            cb = self.cl
            self._pop_l()
            fr._run_cb(cb, t)
        while self.cp is not None and self.hp <= 1e-3:
            cb = self.cp
            self._pop_p()
            fr._run_cb(cb, t)

    def send(self, fr: "_Frame", t: float, size, cbdesc, clsidx: int,
             flow: int):
        self._advance(t)
        self._flush(fr, t)
        self.nbytes += size
        if clsidx == CLS_LINE:
            if self.cl is not None:
                self.ql.append((size, cbdesc))
            else:
                self.hl = size
                self.cl = cbdesc
        else:
            if self.cp is not None:
                self.qp.append((size, cbdesc))
            else:
                self.hp = size
                self.cp = cbdesc
        self._schedule(fr, t)

    def backlog(self, t: float) -> float:
        q = sum(sz for d in (self.ql, self.qp) for sz, _ in d)
        return q + sum((r if r > 0.0 else 0.0) for r in (self.hl, self.hp))


class _BShared:
    """SharedLink machinery over list-indexed lanes.  Subclasses fix the
    channel layout and the per-segment rate math (specialized, alloc-free
    `_advance`/`_schedule` instead of the oracle's rate-vector hook)."""

    __slots__ = ("bw", "n", "sched", "heads", "cbs", "qs", "last", "epoch",
                 "nbytes")

    def __init__(self, bw: float, n_chan: int,
                 sched: Optional[LinkSchedule]):
        self.bw = bw
        self.n = n_chan
        self.sched = sched if (sched is not None and sched.bw_active) else None
        self.heads = [0.0] * n_chan
        self.cbs: List[Optional[tuple]] = [None] * n_chan
        self.qs = [deque() for _ in range(n_chan)]
        self.last = 0.0
        self.epoch = 0
        self.nbytes = 0.0

    def _advance(self, t: float):
        raise NotImplementedError

    def _schedule(self, fr: "_Frame", t: float):
        raise NotImplementedError

    def _push_fire(self, fr: "_Frame", t: float, eta: float, best: int):
        sched = self.sched
        if sched is not None:
            nb = sched.next_boundary(t)
            if eta > nb:
                eta = nb  # re-derive rates at the epoch boundary
        s = fr.seq
        heappush(fr.heap, (eta, s, K_FIRE, self, (best, self.epoch)))
        fr.seq = s + 1

    def fire(self, fr: "_Frame", tt: float, c: int, epoch: int):
        if epoch != self.epoch:
            return  # stale
        self._advance(tt)
        if self.heads[c] > 1e-3:
            self._schedule(fr, tt)
            return
        # several lanes can drain at the same instant under fair shares:
        # complete every finished head in channel order, as the oracle does
        heads = self.heads
        cbs = self.cbs
        done = []
        for ch in range(self.n):
            if cbs[ch] is not None and heads[ch] <= 1e-3:
                done.append(cbs[ch])
                self._pop_next(ch)
        self._schedule(fr, tt)
        for cb in done:
            fr._run_cb(cb, tt)

    def _pop_next(self, c: int):
        q = self.qs[c]
        if q:
            size, cb = q.popleft()
            self.heads[c] = size
            self.cbs[c] = cb
        else:
            self.heads[c] = 0.0
            self.cbs[c] = None

    def _flush(self, fr: "_Frame", t: float):
        heads = self.heads
        cbs = self.cbs
        for c in range(self.n):
            while cbs[c] is not None and heads[c] <= 1e-3:
                cb = cbs[c]
                self._pop_next(c)
                fr._run_cb(cb, t)

    def _chan(self, flow: int, clsidx: int) -> int:
        raise NotImplementedError

    def send(self, fr: "_Frame", t: float, size, cbdesc, clsidx: int,
             flow: int):
        self._advance(t)
        self._flush(fr, t)
        self.nbytes += size
        c = self._chan(flow, clsidx)
        if self.cbs[c] is not None:
            self.qs[c].append((size, cbdesc))
        else:
            self.heads[c] = size
            self.cbs[c] = cbdesc
        self._schedule(fr, t)

    def backlog(self, t: float) -> float:
        q = sum(sz for d in self.qs for sz, _ in d)
        return q + sum((r if r > 0.0 else 0.0) for r in self.heads)


class _BSharedFifo(_BShared):
    """SharedFifoLink: one lane per CC flow, fluid fair share.  The rate is
    a single scalar (``fair_split`` is bw / n_active), so advance/schedule
    run without allocating a rate vector."""

    def _chan(self, flow: int, clsidx: int) -> int:
        return flow

    def _advance(self, t: float):
        heads = self.heads
        busy = 0
        for h in heads:
            if h > 0:
                busy += 1
        if not busy:
            if t > self.last:
                self.last = t
            return
        n = self.n
        sched = self.sched
        last = self.last
        if sched is None:
            if last < t:
                # fair_split(busy, bw) * dt, one segment
                r = (self.bw / busy) * (t - last)
                for i in range(n):
                    h = heads[i]
                    if h > 0:
                        v = h - r
                        heads[i] = v if v > 0.0 else 0.0
                self.last = t
            return
        while last < t:
            nb = sched.next_boundary(last)
            seg = t if t < nb else nb
            dt = seg - last
            if dt > 0:
                busy = 0
                for h in heads:
                    if h > 0:
                        busy += 1
                if busy:
                    r = (self.bw * sched.bw_mult(last) / busy) * dt
                    for i in range(n):
                        h = heads[i]
                        if h > 0:
                            v = h - r
                            heads[i] = v if v > 0.0 else 0.0
            last = seg
        self.last = last

    def _schedule(self, fr: "_Frame", t: float):
        self.epoch += 1
        heads = self.heads
        busy = 0
        for h in heads:
            if h > 0:
                busy += 1
        if not busy:
            return
        sched = self.sched
        bw = self.bw * sched.bw_mult(t) if sched is not None else self.bw
        r = bw / busy
        eta = -1.0
        best = 0
        for i in range(self.n):
            h = heads[i]
            if h > 0:
                e2 = t + h / r
                if eta < 0.0 or e2 < eta:
                    eta = e2
                    best = i
        self._push_fire(fr, t, eta, best)


class _BSharedDual(_BShared):
    """SharedDualQueueLink: (flow, class) lanes; channel f*2 is flow f's
    line lane and f*2+1 its page lane — the oracle's channel order.  Rates
    collapse to two scalars (line / page class shares)."""

    __slots__ = ("ls",)

    def __init__(self, bw: float, line_share: float, n_flows: int,
                 sched: Optional[LinkSchedule]):
        super().__init__(bw, 2 * n_flows, sched)
        self.ls = line_share

    def _chan(self, flow: int, clsidx: int) -> int:
        return flow * 2 + clsidx

    def _advance(self, t: float):
        heads = self.heads
        busy = False
        for h in heads:
            if h > 0:
                busy = True
                break
        if not busy:
            if t > self.last:
                self.last = t
            return
        n = self.n
        sched = self.sched
        last = self.last
        ls = self.ls
        while last < t:
            if sched is None:
                seg = t
            else:
                nb = sched.next_boundary(last)
                seg = t if t < nb else nb
            dt = seg - last
            if dt > 0:
                nl = 0
                npg = 0
                for i in range(0, n, 2):
                    if heads[i] > 0:
                        nl += 1
                for i in range(1, n, 2):
                    if heads[i] > 0:
                        npg += 1
                if nl or npg:
                    bw = (self.bw if sched is None
                          else self.bw * sched.bw_mult(last))
                    lr, pr = class_share_split(nl, npg, bw, ls)
                    lrd = lr * dt
                    prd = pr * dt
                    for i in range(0, n, 2):
                        h = heads[i]
                        if h > 0:
                            v = h - lrd
                            heads[i] = v if v > 0.0 else 0.0
                    for i in range(1, n, 2):
                        h = heads[i]
                        if h > 0:
                            v = h - prd
                            heads[i] = v if v > 0.0 else 0.0
            last = seg
        self.last = last

    def _schedule(self, fr: "_Frame", t: float):
        self.epoch += 1
        heads = self.heads
        n = self.n
        nl = 0
        npg = 0
        for i in range(0, n, 2):
            if heads[i] > 0:
                nl += 1
        for i in range(1, n, 2):
            if heads[i] > 0:
                npg += 1
        if not (nl or npg):
            return
        sched = self.sched
        bw = self.bw * sched.bw_mult(t) if sched is not None else self.bw
        lr, pr = class_share_split(nl, npg, bw, self.ls)
        eta = -1.0
        best = 0
        for i in range(n):
            h = heads[i]
            if h > 0:
                r = lr if (i & 1) == 0 else pr
                if r > 0:
                    e2 = t + h / r
                    if eta < 0.0 or e2 < eta:
                        eta = e2
                        best = i
        if eta < 0.0:
            return  # reserved-share starvation: no drainable lane
        self._push_fire(fr, t, eta, best)


# --------------------------------------------------------------------------
# per-cell frame: the transcribed simulator
# --------------------------------------------------------------------------

_GRAN = {"none": 0, "line": 1, "page": 2, "both": 3, "adaptive": 3}


class _Frame:
    """One sweep cell mid-flight: its event heap, cores, caches, links, and
    counters.  ``advance(quantum)`` pops up to ``quantum`` events; the batch
    driver round-robins frames until every heap drains."""

    def __init__(self, cfg: SimConfig, pol: MovementPolicy,
                 preps: List[List[tuple]], workload: str, seed: int,
                 scheds: List[LinkSchedule]):
        self.cfg = cfg
        self.pol = pol
        self.workload = workload
        self.heap: List[tuple] = []
        self.seq = 0
        self.events = 0
        self.cpu_s = 0.0

        # --- localized config scalars (hot-loop reads) ---
        self.mlp = cfg.mlp
        self.llc_lat = cfg.llc_lat
        self.mem_lat = cfg.mem_lat
        self.rml = cfg.remote_mem_lat
        self.net_lat_c = cfg.net_lat
        self.nl0 = cfg.net_lat * 1.0  # == net_lat * lat_mult(t) when inert
        self.lpp = cfg.page_bytes // cfg.line_bytes
        self.pb = cfg.page_bytes
        self.pb_hb = cfg.page_bytes + cfg.header_bytes
        self.lb_hb = cfg.line_bytes + cfg.header_bytes
        self.hb = cfg.header_bytes
        self.il = cfg.inflight_lines
        self.ip = cfg.inflight_pages
        self.pth = cfg.page_throttle_hi
        self.comp4 = cfg.comp_lat / 4
        self.decomp4 = cfg.decomp_lat / 4
        self.nmcs = cfg.n_mcs
        self.ileave = cfg.mc_interleave
        self.lat_active = cfg.lat_jitter > 0.0
        # memory-side resident state (§2.13): the SAME class the oracle
        # instantiates, driven at the same event points — None keeps the
        # legacy mc_place expressions untouched (golden bit-parity)
        self.mem = make_memside(cfg.n_mcs, cfg.mc_interleave,
                                cfg.mc_capacity_pages,
                                cfg.mem_hot_threshold, cfg.switch_lat)

        # --- policy components ---
        self.gran = _GRAN[pol.granularity]
        self.adaptive = pol.granularity == "adaptive"
        self.free = pol.free_transfers
        self.pcr = pol.page_carries_requests
        self.throttle = pol.throttle
        self.compress_on = pol.compression != "off" and cfg.compress
        # movement controller (§2.12): 'fixed' keeps the transcribed inline
        # expressions verbatim (ctrls[i] = None — no dispatch, no perf cost
        # on the legacy grids); any other controller gets one instance per
        # CC and the decision sites route through decide()/observe_*().
        ctrl_name = resolve_controller(pol, cfg)
        self.ctrls: List = []
        self.any_ctrl = ctrl_name != "fixed"

        # --- per-CC / per-core state (transcribing Simulator.__init__) ---
        # Each core is one record list, indexed positionally in the hot loop:
        #   [0] gaps  [1] lines  [2] writes  [3] n  [4] idx  [5] t
        #   [6] tend  [7] out    [8] stalled [9] cc [10] llc [11] llc_cap
        # LLC and local page caches are raw OrderedDicts with the oracle's
        # LRU semantics inlined at each touch point (access = move_to_end +
        # conditional dirty-set; insert = move_to_end + dirty-or when
        # present, else set + popitem(last=False) past capacity).
        parts = tuple(workload.split("+")) if workload else ("",)
        llc_lines = cfg.llc_bytes // cfg.line_bytes
        ncc = len(preps)
        self.ncc = ncc
        self.cc_workload: List[str] = []
        self.loc_d: List[OrderedDict] = []
        self.loc_cap: List[int] = []
        self.rngs: List[np.random.Generator] = []
        self.comp_base: List[float] = []
        self.pending_lines: List[Dict[int, list]] = []
        self.pending_pages: List[Dict[int, list]] = []
        self.retry: List[deque] = []
        self.cc_cores: List[List[int]] = []
        self.cores: List[list] = []

        for i, group in enumerate(preps):
            w = parts[i % len(parts)]
            footprint = int(max(rawmax + 64 for _, _, _, rawmax in group))
            ks = []
            # LRU() clamps capacity to >= 1, as does the oracle
            per_core_llc = max(1, llc_lines // max(1, len(group)))
            for gaps, lines, writes, _rawmax in group:
                k = len(self.cores)
                ks.append(k)
                self.cores.append([gaps, lines, writes, len(lines), 0, 0.0,
                                   -1.0, deque(), False, i, OrderedDict(),
                                   per_core_llc])
            self.cc_cores.append(ks)
            n_pages_total = footprint // cfg.page_bytes + 1
            self.loc_d.append(OrderedDict())
            self.loc_cap.append(
                max(1, int(n_pages_total * cfg.local_mem_frac)))
            self.cc_workload.append(w)
            self.comp_base.append(
                compressibility_of(w if len(parts) > 1 else workload))
            self.rngs.append(np.random.default_rng(seed + 17) if i == 0
                             else np.random.default_rng((seed + 17, i)))
            self.ctrls.append(
                make_controller(ctrl_name, cfg,
                                w if len(parts) > 1 else workload)
                if self.any_ctrl else None)
            self.pending_lines.append({})
            self.pending_pages.append({})
            self.retry.append(deque())

        # --- per-CC counters (accumulated in event order, rolled into
        # Metrics at the end; float accumulators stay float throughout) ---
        self.m_acc = [0] * ncc
        self.m_llc = [0] * ncc
        self.m_local = [0] * ncc
        self.m_rm = [0] * ncc
        self.m_pages = [0] * ncc
        self.m_lines = [0] * ncc
        self.m_wb = [0] * ncc
        self.m_misslat = [0.0] * ncc
        self.m_net = [0.0] * ncc
        self.m_up = [0.0] * ncc
        self.m_saved = [0.0] * ncc
        self.m_stall = [0.0] * ncc

        # --- links (same construction dispatch as Simulator.__init__) ---
        self.scheds = scheds
        bw = cfg.link_bw
        share = cfg.line_share if pol.line_share is None else pol.line_share
        if pol.partitioning == "dual":
            if ncc == 1:
                self.links = [_BDual(bw, share, s) for s in scheds]
            else:
                self.links = [_BSharedDual(bw, share, ncc, s) for s in scheds]
        else:
            if ncc == 1:
                self.links = [_BFifo(bw, s) for s in scheds]
            else:
                self.links = [_BSharedFifo(bw, ncc, s) for s in scheds]
        if cfg.uplink_bw is None:
            self.uplinks = None
        else:
            ubw = cfg.uplink_bw
            req_share = 1.0 - cfg.writeback_share
            if pol.uplink_partitioning == "dual":
                if ncc == 1:
                    self.uplinks = [_BDual(ubw, req_share, s) for s in scheds]
                else:
                    self.uplinks = [_BSharedDual(ubw, req_share, ncc, s)
                                    for s in scheds]
            else:
                if ncc == 1:
                    self.uplinks = [_BFifo(ubw, s) for s in scheds]
                else:
                    self.uplinks = [_BSharedFifo(ubw, ncc, s) for s in scheds]

        # initial events: one core_step per core, global core order (the
        # oracle's Simulator.start), seq numbers 0..n_cores-1
        for k in range(len(self.cores)):
            self._push(0.0, K_CORE, k, 0)

    # ---------------- event plumbing ----------------
    def _push(self, t: float, kind: int, a, b):
        heappush(self.heap, (t, self.seq, kind, a, b))
        self.seq += 1

    def _net_lat(self, mc: int, t: float) -> float:
        if self.lat_active:
            return self.net_lat_c * self.scheds[mc].lat_mult(t)
        return self.nl0

    def _run_cb(self, cb: tuple, tt: float):
        kind = cb[0]
        if kind == "line":
            _, cc, line, mc = cb
            nl = (self.net_lat_c * self.scheds[mc].lat_mult(tt)
                  if self.lat_active else self.nl0)
            s = self.seq
            heappush(self.heap, (tt + nl, s, K_LINE_ARR, cc, line))
            self.seq = s + 1
        elif kind == "page":
            _, cc, page, mc, hx = cb
            nl = (self.net_lat_c * self.scheds[mc].lat_mult(tt)
                  if self.lat_active else self.nl0)
            arrive = tt + nl + (self.decomp4 if hx else 0.0)
            s = self.seq
            heappush(self.heap, (arrive, s, K_PAGE_ARR, cc, page))
            self.seq = s + 1
        elif kind == "up":
            _, mc, extra, link, size, clsidx, cc, inner = cb
            nl = (self.net_lat_c * self.scheds[mc].lat_mult(tt)
                  if self.lat_active else self.nl0)
            s = self.seq
            heappush(self.heap, (tt + nl + self.rml + extra, s,
                                 K_FLIGHT, link, (size, clsidx, cc, inner)))
            self.seq = s + 1
        # "nop": the oracle's `lambda a: None` writeback callback

    def advance(self, limit: int) -> bool:
        """Pop up to ``limit`` events; returns True while events remain.

        This is the batch core's whole hot path: one flat loop with the
        oracle's core_step / complete / arrival handlers (and the LRU
        touch points they make) inlined at each dispatch arm, so an event
        costs a handful of bytecodes instead of a call chain.  Every
        arithmetic expression keeps the oracle's shape and order.
        """
        heap = self.heap
        cores = self.cores
        push = heappush
        pop = heappop
        mlp = self.mlp
        llc_lat = self.llc_lat
        mem_lat = self.mem_lat
        m_acc = self.m_acc
        m_llc = self.m_llc
        m_stall = self.m_stall
        m_misslat = self.m_misslat
        pending_lines = self.pending_lines
        pending_pages = self.pending_pages
        retry = self.retry
        loc_d = self.loc_d
        loc_cap = self.loc_cap
        miss = self._miss
        ctrls = self.ctrls if self.any_ctrl else None
        n_ev = 0
        while heap and n_ev < limit:
            t, _, kind, a, b = pop(heap)
            n_ev += 1
            if kind == K_CORE:
                # oracle: Simulator.core_step.  Request `done` flags are
                # only flipped by events, so they are fixed for the whole
                # call; `out` mutates only on the misses issued here.
                C = cores[a]
                C[8] = False
                ct = C[5]
                if ct > t:
                    t = ct
                gaps = C[0]
                lines = C[1]
                writes = C[2]
                n = C[3]
                idx = C[4]
                out = C[7]
                d = C[10]
                cc = C[9]
                acc = 0
                hits = 0
                while idx < n:
                    while out and out[0][4]:
                        out.popleft()
                    if len(out) >= mlp:
                        C[8] = True
                        C[4] = idx
                        C[5] = t
                        m_acc[cc] += acc
                        m_llc[cc] += hits
                        m_stall[cc] += 1  # one per mlp-window fill
                        break  # resumed by completion of the oldest request
                    line = lines[idx]
                    wr = writes[idx]
                    t += gaps[idx]
                    idx += 1
                    acc += 1
                    if line in d:  # LLC access(line, wr)
                        d.move_to_end(line)
                        if wr:
                            d[line] = True
                        hits += 1
                        t += llc_lat
                        continue
                    t += llc_lat  # miss detection
                    C[4] = idx
                    miss(cc, C, a, line, wr, t)
                    idx = C[4]
                else:
                    C[4] = idx
                    C[5] = t
                    if t > C[6]:
                        C[6] = t
                    m_acc[cc] += acc
                    m_llc[cc] += hits
            elif kind == K_COMPLETE:
                # oracle: Simulator.complete (a is the request record)
                a[4] = True
                k = a[3]
                C = cores[k]
                m_misslat[C[9]] += t - a[1]
                if C[8]:
                    out = C[7]
                    if out and out[0][4]:
                        s = self.seq
                        push(heap, (t, s, K_CORE, k, 0))
                        self.seq = s + 1
            elif kind == K_FLIGHT:
                size, clsidx, flow, cbdesc = b
                a.send(self, t, size, cbdesc, clsidx, flow)
            elif kind == K_LINE_ARR:
                # oracle: on_line_arrival (a = cc, b = line): LLC-insert +
                # complete every waiter, then drain the retry queue
                if ctrls is not None:
                    ctrls[a].observe_line(t)
                reqs = pending_lines[a].pop(b, ())
                for r in reqs:
                    if not r[4]:
                        k = r[3]
                        C = cores[k]
                        d = C[10]
                        wr = r[2]
                        if b in d:
                            d.move_to_end(b)
                            if wr:
                                d[b] = True
                        else:
                            d[b] = wr
                            if len(d) > C[11]:
                                d.popitem(last=False)
                        r[4] = True
                        m_misslat[C[9]] += t - r[1]
                        if C[8]:
                            out = C[7]
                            if out and out[0][4]:
                                s = self.seq
                                push(heap, (t, s, K_CORE, k, 0))
                                self.seq = s + 1
                if retry[a]:
                    self._drain_retry(a, t)
            elif kind == K_FIRE:
                c, epoch = b
                a.fire(self, t, c, epoch)
            elif kind == K_PAGE_ARR:
                # oracle: on_page_arrival (a = cc, b = page): install the
                # page (dirty eviction -> writeback), complete waiters at
                # t + mem_lat (read from local memory), drain retries
                if ctrls is not None:
                    ctrls[a].observe_page(t)
                loc = loc_d[a]
                if b in loc:
                    loc.move_to_end(b)
                    # insert(page): present-entry dirty bit is unchanged
                else:
                    loc[b] = False
                    if len(loc) > loc_cap[a]:
                        tag, dirty = loc.popitem(last=False)
                        if dirty:
                            self._send_writeback(a, tag, t)
                reqs = pending_pages[a].pop(b, ())
                tm = t + mem_lat
                for r in reqs:
                    if not r[4]:
                        k = r[3]
                        C = cores[k]
                        d = C[10]
                        line = r[0]
                        wr = r[2]
                        if line in d:
                            d.move_to_end(line)
                            if wr:
                                d[line] = True
                        else:
                            d[line] = wr
                            if len(d) > C[11]:
                                d.popitem(last=False)
                        r[4] = True
                        m_misslat[C[9]] += tm - r[1]
                        if C[8]:
                            out = C[7]
                            if out and out[0][4]:
                                s = self.seq
                                push(heap, (tm, s, K_CORE, k, 0))
                                self.seq = s + 1
                if retry[a]:
                    self._drain_retry(a, t)
            elif kind == K_TXDONE:
                self._run_cb(a, t)
            else:  # K_WBSEND
                size, flow = b
                a.send(self, t, size, NOP, CLS_PAGE, flow)
        self.events += n_ev
        return bool(heap)

    # ---------------- miss handling (oracle: Simulator.miss) -------------
    def _local_hit(self, cc: int, C: list, k: int, line: int, wr: bool,
                   t: float):
        self.m_local[cc] += 1
        d = C[10]
        if line in d:  # LLC insert(line, wr)
            d.move_to_end(line)
            if wr:
                d[line] = True
        else:
            d[line] = wr
            if len(d) > C[11]:
                d.popitem(last=False)
        req = [line, t, wr, k, False]
        if not wr:
            C[7].append(req)
        self._push(t + self.mem_lat, K_COMPLETE, req, 0)

    def _miss(self, cc: int, C: list, k: int, line: int, wr: bool, t: float):
        gran = self.gran
        if gran == 0:  # 'none': every miss is local DRAM
            self._local_hit(cc, C, k, line, wr, t)
            return
        if gran == 1:  # 'line': line movement only
            self.m_rm[cc] += 1
            req = [line, t, wr, k, False]
            if not wr:
                C[7].append(req)
            self._fetch_line(cc, line, t, req)
            return
        page = line // self.lpp
        loc = self.loc_d[cc]
        if page in loc:  # page-cache access(page, wr)
            loc.move_to_end(page)
            if wr:
                loc[page] = True
            self._local_hit(cc, C, k, line, wr, t)
            return
        self.m_rm[cc] += 1
        if self.free:  # idealized locality bound
            self._insert_page(cc, page, t)
            self.m_pages[cc] += 1
            self.m_local[cc] -= 1  # counted as remote, not a local hit
            self._local_hit(cc, C, k, line, wr, t)
            return
        if gran == 2:  # 'page': requests ride the page migration
            req = [line, t, wr, k, False]
            if not wr:
                C[7].append(req)
            pp = self.pending_pages[cc]
            lst = pp.get(page)
            if lst is not None:
                lst.append(req)
            else:
                pp[page] = [req]
                self._send_page(cc, page, t)
            return
        self._composed_miss(cc, C, k, line, wr, t)

    def _composed_miss(self, cc: int, C: list, k: int, line: int, wr: bool,
                       t: float):
        pl = self.pending_lines[cc]
        pp = self.pending_pages[cc]
        page = line // self.lpp
        req = [line, t, wr, k, False]
        if not wr:
            C[7].append(req)
        lu = len(pl) / self.il
        pu = len(pp) / self.ip

        # movement controller (§2.12): observe-then-decide, in the
        # oracle's order; None is the transcribed 'fixed' fast path
        plist = pp.get(page)
        ctrl = self.ctrls[cc]
        if ctrl is not None:
            ctrl.observe_miss(plist is not None)
            d = ctrl.decide(self._ctrl_obs(ctrl, cc, page, t, lu, pu))

        # coalesce with an inflight page migration
        if plist is not None:
            if self.pcr:
                plist.append(req)
            llist = pl.get(line)
            if llist is not None:
                llist.append(req)
            elif self.adaptive:
                if (selection_races_line(lu, pu) if ctrl is None
                        else d.race_line):
                    pl[line] = [req]
                    self._fetch_line_daemon(cc, line, t)
            elif not self.pcr:
                pl[line] = [req]
                self._fetch_line_daemon(cc, line, t)
            return

        # triggering miss: BOTH by default
        if self.throttle:
            if ctrl is None:
                issue_page = pu < self.pth
                issue_line = lu < 1.0 or line in pl
            else:
                issue_page = d.issue_page
                issue_line = d.issue_line or line in pl
            if not issue_line and not issue_page:
                self.retry[cc].append(req)  # buffers full: park for re-issue
                return
        else:
            issue_page = issue_line = True

        promote = False
        if issue_line:
            llist = pl.get(line)
            if llist is not None:
                llist.append(req)
            else:
                pl[line] = [req]
                promote = self._fetch_line_daemon(cc, line, t)
        if issue_page:
            waiting = pp.setdefault(page, [])
            if self.pcr:
                waiting.append(req)
            self._send_page(cc, page, t)
        if promote:
            # oracle ordering: promotion runs after the demand page-issue
            # bookkeeping so a triggering miss never double-sends the page
            self._maybe_promote(cc, page, t)

    def _drain_retry(self, cc: int, t: float):
        rq = self.retry[cc]
        n = len(rq)
        pl = self.pending_lines[cc]
        pp = self.pending_pages[cc]
        ctrl = self.ctrls[cc]
        for _ in range(n):
            req = rq.popleft()
            if req[R_DONE]:
                continue
            line = req[R_ADDR]
            lu = len(pl) / self.il
            pu = len(pp) / self.ip
            page = line // self.lpp
            if ctrl is not None:
                d = ctrl.decide(self._ctrl_obs(ctrl, cc, page, t, lu, pu))
            llist = pl.get(line)
            if llist is not None:
                llist.append(req)
            elif page in pp:
                pp[page].append(req)
            elif (lu < 1.0 if ctrl is None else d.issue_line):
                pl[line] = [req]
                if self._fetch_line_daemon(cc, line, t):
                    self._maybe_promote(cc, page, t)
            elif (pu < self.pth if ctrl is None else d.issue_page):
                pp[page] = [req]
                self._send_page(cc, page, t)
            else:
                rq.append(req)

    # ---------------- transfers ----------------
    def _request_flight(self, cc: int, mc: int, t: float, extra: float,
                        link, size, clsidx: int, cbdesc: tuple):
        if self.uplinks is None:
            self._push(t + self._net_lat(mc, t) + self.rml + extra,
                       K_FLIGHT, link, (size, clsidx, cc, cbdesc))
            return
        self.m_up[cc] += self.hb
        self.uplinks[mc].send(
            self, t, self.hb,
            ("up", mc, extra, link, size, clsidx, cc, cbdesc), CLS_LINE, cc)

    def _fetch_line(self, cc: int, line: int, t: float, req: list):
        pl = self.pending_lines[cc]
        lst = pl.get(line)
        if lst is not None:  # coalesce with the inflight fetch
            lst.append(req)
            return
        pl[line] = [req]
        self.m_lines[cc] += 1
        page = line // self.lpp
        if self.mem is None:
            mc, xl = mc_place(page, self.nmcs, self.ileave), 0.0
        else:  # oracle: _fetch_line — the promotion signal is moot for
            # line-granularity policies (no local page cache)
            mc, xl, _ = self.mem.touch(cc, page, "line")
        size = self.lb_hb
        self._request_flight(cc, mc, t, xl, self.links[mc], size, CLS_LINE,
                             ("line", cc, line, mc))
        self.m_net[cc] += size

    def _fetch_line_daemon(self, cc: int, line: int, t: float) -> bool:
        # oracle: _fetch_line_daemon — returns the §2.13 hot-page
        # promotion signal for the caller to act on after page-issue
        # bookkeeping settles
        self.m_lines[cc] += 1
        page = line // self.lpp
        if self.mem is None:
            mc, xl, promote = (mc_place(page, self.nmcs, self.ileave),
                               0.0, False)
        else:
            mc, xl, promote = self.mem.touch(cc, page, "line")
        size = self.lb_hb
        self.m_net[cc] += size
        self._request_flight(cc, mc, t, xl, self.links[mc], size, CLS_LINE,
                             ("line", cc, line, mc))
        return promote

    def _maybe_promote(self, cc: int, page: int, t: float):
        # oracle: _maybe_promote — hot-page promotion toward the owning
        # CC, throttled by the backlog signal (inflight page buffer has
        # room), waiterless like the oracle's pending_pages[page] = []
        pp = self.pending_pages[cc]
        if page in pp or page in self.loc_d[cc]:
            return
        if len(pp) >= self.ip:
            return
        self.mem.promotions += 1
        pp[page] = []
        self._send_page(cc, page, t)

    def _ctrl_obs(self, ctrl, cc: int, page: int, t: float,
                  lu: float, pu: float) -> Observation:
        # oracle: Simulator._obs — the uplink backlog (toward the page's
        # MC) only for controllers that declare needs_uplink; the
        # resident-MC read is the pure peek (§2.13), never a touch
        ub = 0.0
        if ctrl.needs_uplink and self.uplinks is not None:
            mc = (mc_place(page, self.nmcs, self.ileave)
                  if self.mem is None else self.mem.peek(cc, page))
            ub = self.uplinks[mc].backlog(t)
        return Observation(t, lu, pu, ub)

    def _send_page(self, cc: int, page: int, t: float):
        if self.mem is None:
            mc, xl = mc_place(page, self.nmcs, self.ileave), 0.0
        else:  # oracle: _send_page — 'page' touch resets the hotness count
            mc, xl, _ = self.mem.touch(cc, page, "page")
        raw = self.pb_hb
        size = raw
        extra = 0.0
        if self.compress_on:
            ctrl = self.ctrls[cc]
            pu = len(self.pending_pages[cc]) / self.ip
            if ctrl is None:
                comp = pu > PAGE_FAST
            else:
                lu = len(self.pending_lines[cc]) / self.il
                comp = ctrl.decide(
                    self._ctrl_obs(ctrl, cc, page, t, lu, pu)).compress
            if comp:
                base = self.comp_base[cc]
                r = self.rngs[cc].normal(base, 0.15 * base)
                ratio = r if r > 1.0 else 1.0  # max(1.0, r)
                size = self.pb / ratio + self.hb
                extra = self.comp4
                self.m_saved[cc] += raw - size
        self.m_net[cc] += size
        self.m_pages[cc] += 1
        # xl charges the spilled-resident detour (§2.13) on the request
        # path; decompression stays keyed on `extra` alone (bool below)
        self._request_flight(cc, mc, t, extra + xl, self.links[mc], size,
                             CLS_PAGE, ("page", cc, page, mc, bool(extra)))

    def _send_writeback(self, cc: int, page: int, t: float):
        if self.mem is None:
            mc, xl = mc_place(page, self.nmcs, self.ileave), 0.0
        else:  # oracle: _send_writeback — 'wb' touch re-allocates a
            # backing page the pool evicted
            mc, xl, _ = self.mem.touch(cc, page, "wb")
        raw = self.pb_hb
        size = raw
        extra = 0.0
        self.m_wb[cc] += 1
        ctrl = self.ctrls[cc]
        if self.uplinks is None:
            # legacy: writeback injected into the *downlink* queue
            link = self.links[mc]
            if self.compress_on:
                pu = len(self.pending_pages[cc]) / self.ip
                if ctrl is None:
                    comp = pu > PAGE_FAST
                else:
                    lu = len(self.pending_lines[cc]) / self.il
                    comp = ctrl.decide(
                        self._ctrl_obs(ctrl, cc, page, t, lu, pu)).compress
                if comp:
                    base = self.comp_base[cc]
                    r = self.rngs[cc].normal(base, 0.15 * base)
                    ratio = r if r > 1.0 else 1.0
                    size = self.pb / ratio + self.hb
                    extra = self.comp4
                    self.m_saved[cc] += raw - size
            self.m_net[cc] += size
            self._push(t + extra + xl, K_WBSEND, link, (size, cc))
            return
        up = self.uplinks[mc]
        if ctrl is None:
            comp = self.compress_on and up.backlog(t) > self.pb
        else:
            lu = len(self.pending_lines[cc]) / self.il
            pu = len(self.pending_pages[cc]) / self.ip
            comp = self.compress_on and ctrl.decide(
                Observation(t, lu, pu, up.backlog(t))).compress_writeback
        if comp:
            base = self.comp_base[cc]
            r = self.rngs[cc].normal(base, 0.15 * base)
            ratio = r if r > 1.0 else 1.0
            size = self.pb / ratio + self.hb
            extra = self.comp4
            self.m_saved[cc] += raw - size
        self.m_up[cc] += size
        self._push(t + extra + xl, K_WBSEND, up, (size, cc))

    def _insert_page(self, cc: int, page: int, t: float):
        # page-cache insert(page); dirty eviction past capacity -> writeback
        loc = self.loc_d[cc]
        if page in loc:
            loc.move_to_end(page)
            # present-entry dirty bit is unchanged (dirty-or with False)
        else:
            loc[page] = False
            if len(loc) > self.loc_cap[cc]:
                tag, dirty = loc.popitem(last=False)
                if dirty:
                    self._send_writeback(cc, tag, t)

    # arrivals (oracle: on_line_arrival / on_page_arrival) are inlined in
    # advance() at the K_LINE_ARR / K_PAGE_ARR dispatch arms.

    # ---------------- results ----------------
    def result(self) -> Metrics:
        """Assemble Metrics exactly as Simulator.run() does: per-CC rollup
        in CC order, cycles as the makespan, per_cc entries for n_ccs>1."""
        scheme = self.pol.name
        ms = []
        for i in range(self.ncc):
            wl = self.workload if self.ncc == 1 else self.cc_workload[i]
            mm = Metrics(scheme=scheme, workload=wl)
            mm.accesses = self.m_acc[i]
            mm.llc_hits = self.m_llc[i]
            mm.local_hits = self.m_local[i]
            mm.remote_misses = self.m_rm[i]
            mm.miss_latency_sum = self.m_misslat[i]
            mm.net_bytes = self.m_net[i]
            mm.uplink_bytes = self.m_up[i]
            mm.pages_moved = self.m_pages[i]
            mm.lines_moved = self.m_lines[i]
            mm.writebacks = self.m_wb[i]
            mm.bytes_saved_compression = self.m_saved[i]
            mm.stall_episodes = self.m_stall[i]
            mm.cycles = max(self.cores[k][6] for k in self.cc_cores[i])
            ms.append(mm)
        if self.ncc == 1:
            self._memside_rollup(ms[0])
            return ms[0]
        m = Metrics(scheme=scheme, workload=self.workload)
        for i, cc in enumerate(ms):
            m.accesses += cc.accesses
            m.llc_hits += cc.llc_hits
            m.local_hits += cc.local_hits
            m.remote_misses += cc.remote_misses
            m.miss_latency_sum += cc.miss_latency_sum
            m.net_bytes += cc.net_bytes
            m.uplink_bytes += cc.uplink_bytes
            m.pages_moved += cc.pages_moved
            m.lines_moved += cc.lines_moved
            m.writebacks += cc.writebacks
            m.bytes_saved_compression += cc.bytes_saved_compression
            m.stall_episodes += cc.stall_episodes
            d = cc.as_dict()
            d.pop("per_cc")
            d["cc"] = i
            m.per_cc.append(d)
        m.cycles = max(cc.cycles for cc in ms)
        self._memside_rollup(m)
        return m

    def _memside_rollup(self, m: Metrics):
        # oracle: Simulator._memside_rollup — §2.13 pool counters are
        # cell-global (the pool is shared), so per_cc entries stay zero
        if self.mem is not None:
            m.mc_spills = self.mem.spills
            m.mc_evictions = self.mem.evictions
            m.mc_promotions = self.mem.promotions


# --------------------------------------------------------------------------
# batch driver
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchCell:
    """One sweep cell, fully resolved (run_one's signature as data)."""

    workload: str
    scheme: Any
    cfg: SimConfig
    seed: int = 0
    n_accesses: int = 60_000
    footprint: int = 16 << 20
    n_jobs: int = 1


@dataclass
class BatchState:
    """Struct-of-arrays view over the batch, synced at every lockstep
    quantum boundary: per-cell core cursors, fluid-link backlogs, and
    selection-unit counters.  This is the driver's observation surface —
    progress/throughput reporting reads these arrays, never the frames."""

    n_cells: int
    # core cursors: furthest core time and total issued accesses per cell
    t_now: np.ndarray = field(default=None)          # (n_cells,) float64
    accesses: np.ndarray = field(default=None)       # (n_cells,) int64
    events: np.ndarray = field(default=None)         # (n_cells,) int64
    # fluid-link backlogs and selection-unit occupancy per cell
    link_backlog: np.ndarray = field(default=None)   # (n_cells,) float64
    inflight_lines: np.ndarray = field(default=None)  # (n_cells,) int64
    inflight_pages: np.ndarray = field(default=None)  # (n_cells,) int64
    retry_depth: np.ndarray = field(default=None)    # (n_cells,) int64
    done: np.ndarray = field(default=None)           # (n_cells,) bool

    def __post_init__(self):
        n = self.n_cells
        self.t_now = np.zeros(n)
        self.accesses = np.zeros(n, dtype=np.int64)
        self.events = np.zeros(n, dtype=np.int64)
        self.link_backlog = np.zeros(n)
        self.inflight_lines = np.zeros(n, dtype=np.int64)
        self.inflight_pages = np.zeros(n, dtype=np.int64)
        self.retry_depth = np.zeros(n, dtype=np.int64)
        self.done = np.zeros(n, dtype=bool)

    def sync(self, i: int, fr: _Frame, done: bool):
        t = max((C[5] for C in fr.cores), default=0.0)
        self.t_now[i] = t
        self.accesses[i] = sum(fr.m_acc)
        self.events[i] = fr.events
        self.link_backlog[i] = sum(ln.backlog(t) for ln in fr.links)
        self.inflight_lines[i] = sum(len(d) for d in fr.pending_lines)
        self.inflight_pages[i] = sum(len(d) for d in fr.pending_pages)
        self.retry_depth[i] = sum(len(q) for q in fr.retry)
        self.done[i] = done


@dataclass
class BatchResult:
    metrics: List[Metrics]
    cpu_s: List[float]
    state: BatchState
    events: int = 0


def _build_frame(cell: BatchCell, tp: TracePool, sp: SchedPool) -> _Frame:
    """Resolve one cell into a frame, replicating run_one's trace-group
    derivation (seeding, '+'-mix round-robin, per-thread splits)."""
    cfg = cell.cfg
    pol = get_policy(cell.scheme)
    n_ccs = max(1, cfg.n_ccs)
    wl = cell.workload
    parts = tuple(wl.split("+")) if wl else (wl,)
    n_threads = max(1, cfg.n_cores) * max(1, cell.n_jobs)
    per = max(1, cell.n_accesses // n_threads)
    gs = cfg.gap_scale
    if n_ccs == 1 and len(parts) == 1:
        preps = [[tp.get(wl, cell.seed + j, cell.footprint, per, gs)
                  for j in range(n_threads)]]
    else:
        preps = [
            [tp.get(parts[c % len(parts)], cell.seed + c * n_threads + j,
                    cell.footprint, per, gs)
             for j in range(n_threads)]
            for c in range(n_ccs)
        ]
    scheds = [sp.get(cfg.jitter_period, cfg.bw_jitter, cfg.lat_jitter,
                     cfg.jitter_seed * 1000 + mc)
              for mc in range(cfg.n_mcs)]
    return _Frame(cfg, pol, preps, wl, cell.seed, scheds)


def run_batch(cells: Sequence[BatchCell], quantum: int = 8192,
              trace_pool: Optional[TracePool] = None,
              sched_pool: Optional[SchedPool] = None) -> BatchResult:
    """Advance every cell to completion in lockstep rounds of ``quantum``
    events, sharing trace/schedule pools across the batch.  Results are
    positionally aligned with ``cells`` and bit-identical to running each
    cell through the oracle (``run_one``)."""
    tp = trace_pool if trace_pool is not None else TracePool()
    sp = sched_pool if sched_pool is not None else SchedPool()
    frames: List[_Frame] = []
    for cell in cells:
        reason = uncovered_reason(cell.cfg, cell.scheme)
        if reason is not None:
            raise ValueError(
                f"batch engine does not cover cell {cell!r}: {reason}; "
                f"route it to the oracle (see covers())")
        t0 = time.process_time()
        fr = _build_frame(cell, tp, sp)
        fr.cpu_s += time.process_time() - t0
        frames.append(fr)
    state = BatchState(len(frames))
    active = list(range(len(frames)))
    # the hot loop allocates only short-lived tuples/lists that refcounting
    # alone reclaims; generational GC passes just scan the (large) live heap
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        while active:
            nxt = []
            for i in active:
                fr = frames[i]
                t0 = time.process_time()
                more = fr.advance(quantum)
                fr.cpu_s += time.process_time() - t0
                state.sync(i, fr, not more)
                if more:
                    nxt.append(i)
            active = nxt
    finally:
        if gc_was_enabled:
            gc.enable()
    return BatchResult(
        metrics=[fr.result() for fr in frames],
        cpu_s=[fr.cpu_s for fr in frames],
        state=state,
        events=int(state.events.sum()),
    )
