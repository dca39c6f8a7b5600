"""Request-level disaggregated LLM serving layer (DESIGN.md §2.9).

The paper's robustness claim is evaluated closed-loop — every CC replays
one fixed stream end to end.  Production disaggregated-memory deployments
live or die by different numbers: request tail latency (p50/p99) and
goodput under load.  This module stitches the captured Hopper-kernel
streams (DESIGN.md §2.8) into *requests* and schedules them onto the
multi-CC simulator through the existing contended downlink/uplink
machinery:

- A :class:`RequestSpec` is one LLM inference request: a prefill phase
  (one ``prefill_workload`` burst of ``prefill_accesses``) followed by
  ``decode_steps`` decode phases (``decode_accesses`` each), every phase a
  deterministic ``replay_slice`` of the workload's captured trace (the
  per-request seed rotates the replay offset, so requests touch
  overlapping-but-shifted KV pages).
- Arrivals are open-loop: seeded exponential inter-arrival draws at
  ``offered_load`` requests per Mcycle.  The arrival process is a pure
  function of the cell seed — identical across schemes and sweep workers.
- A registered :class:`RouterPolicy` assigns each request's phases to CCs:
  ``round_robin`` and ``least_loaded`` keep a request on one CC;
  ``disagg_prefill`` splits the CCs into a prefill pool and a decode pool
  (vLLM-style prefill/decode disaggregation).  The KV handoff is modeled
  organically: the decode CC's local page cache is cold for the pages the
  prefill CC just filled, so its first decode slices re-fetch the
  MC-resident KV pages through the contended links.
- Per-CC heterogeneous :class:`~repro_torch.core.sim.policy.MovementPolicy`
  (``serving_prefill_policy`` / ``serving_decode_policy``) lets each pool
  run its own movement composition; the engine's SharedHeteroLink
  arbitrates the mixed flows on the shared per-MC downlinks.

Each CC offers ``cfg.n_cores`` request slots (one phase occupies one
core); excess work queues FIFO per CC.  A phase completes when its core
has issued the whole slice and its outstanding reads drained (write fills
land asynchronously — write-release semantics).  Per-request completion
cycles roll up into the Metrics extensions ``request_p50`` /
``request_p99`` / ``goodput`` plus a full per-request record list.

With ``cfg.mc_capacity_pages`` set (§2.13), the serving run's tenants
contend for the finite memory pool too: every phase's working set is
allocated through the shared :class:`~repro_torch.core.sim.memside.MemsideState`,
so skewed '+'-mixes (one tenant's KV pages crowding out another's) show up
as cross-MC spills and cold-resident evictions in ``mc_spills`` /
``mc_evictions`` — no serving-layer code is capacity-aware; the pressure
flows through the same engine hooks the closed-loop model uses.

Port departure (the fifth beside the four kernel-stream seams of
:mod:`repro_torch.core.sim`): a queued phase keeps the cycle it became
ready at, and a core that pops it starts it no earlier than that cycle.
``repro.core.sim.serving`` queues ``(req, phase)`` alone and starts the
phase at the popping core's own clock, which ``core_step`` may have left
behind the event that queued it: under ``disagg_prefill`` a decode phase
then begins before its prefill ended.  Where no queued phase would start
early, the two give equal ``Metrics``
(tests/test_torch_sim_serving_order.py).

Everything is deterministic given (cfg, scheme, seed): serial runs,
pooled sweep workers, and repeated processes produce bit-identical
per-request completion cycles (locked by tests/test_serving.py).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sim.config import Metrics, SimConfig
from repro_torch.core.sim.engine import Core, Simulator
from repro_torch.core.sim.policy import get_policy
from repro_torch.core.sim.trace import Trace, generate

# footprint handed to synthetic phase workloads (captured kernels ignore
# it: their tiling geometry is authoritative); matches run_one's default
PHASE_FOOTPRINT = 16 << 20

_ARRIVAL_SALT = 0x5EED  # decorrelates arrival draws from trace seeds


# --------------------------------------------------------------------------
# request model
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RequestSpec:
    """One inference request: phases[0] is the prefill burst, phases[1:]
    are the decode steps; ``arrival`` is its open-loop arrival cycle."""

    rid: int
    arrival: float
    phases: Tuple[Trace, ...]


@dataclass
class RequestRecord:
    """Mutable per-request lifecycle record (rolled into Metrics.requests).
    Times are NaN until the corresponding event happens; CC indices are -1
    until assigned."""

    rid: int
    arrival: float
    prefill_cc: int = -1
    decode_cc: int = -1
    t_start: float = math.nan  # prefill began issuing on a core
    t_prefill_done: float = math.nan
    t_done: float = math.nan  # last decode phase drained

    @property
    def completed(self) -> bool:
        return not math.isnan(self.t_done)

    @property
    def arrived(self) -> bool:
        return self.prefill_cc >= 0

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival

    def as_dict(self) -> dict:
        return {
            "rid": self.rid,
            "arrival": self.arrival,
            "prefill_cc": self.prefill_cc,
            "decode_cc": self.decode_cc,
            "t_start": self.t_start,
            "t_prefill_done": self.t_prefill_done,
            "t_done": self.t_done,
            "latency": self.latency,
        }


def request_arrivals(cfg: SimConfig, seed: int) -> np.ndarray:
    """Open-loop Poisson arrival cycles: seeded exponential inter-arrival
    draws at ``offered_load`` requests per Mcycle.  A pure function of
    (cfg, seed) — schemes and sweep workers see identical arrivals."""
    rng = np.random.default_rng((seed, _ARRIVAL_SALT))
    gaps = rng.exponential(scale=1e6 / cfg.offered_load, size=cfg.n_requests)
    return np.cumsum(gaps)


def build_requests(cfg: SimConfig, seed: int) -> List[RequestSpec]:
    """Materialize the request set: per-request phase traces via the
    registered workload generators (captured kernels route through
    ``replay_slice``, so the per-request seed rotates the replay offset —
    each request's KV pages overlap-but-shift against its neighbors')."""
    arrivals = request_arrivals(cfg, seed)
    reqs = []
    for rid in range(cfg.n_requests):
        base = seed + 101 * rid
        phases = [generate(cfg.prefill_workload, seed=base,
                           footprint=PHASE_FOOTPRINT, n=cfg.prefill_accesses)]
        for k in range(cfg.decode_steps):
            phases.append(generate(cfg.decode_workload, seed=base + 7 * (k + 1),
                                   footprint=PHASE_FOOTPRINT,
                                   n=cfg.decode_accesses))
        reqs.append(RequestSpec(rid=rid, arrival=float(arrivals[rid]),
                                phases=tuple(phases)))
    return reqs


# --------------------------------------------------------------------------
# router registry
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RouterPolicy:
    """One request-routing policy.  ``pools`` returns (prefill_pool,
    decode_pool) CC index tuples; ``pick`` chooses a CC from a pool given
    the current per-CC loads (busy cores + queued phases).  ``handoff``
    routers move a request to the decode pool after prefill (disjoint
    pools); non-handoff routers keep all phases on the arrival CC."""

    name: str
    description: str = ""
    handoff: bool = False

    def pools(self, n_ccs: int, cfg: SimConfig) -> Tuple[Tuple[int, ...],
                                                         Tuple[int, ...]]:
        ccs = tuple(range(n_ccs))
        return ccs, ccs

    def pick(self, pool: Sequence[int], loads: Sequence[int], rid: int) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class RoundRobinRouter(RouterPolicy):
    def pick(self, pool: Sequence[int], loads: Sequence[int], rid: int) -> int:
        return pool[rid % len(pool)]


@dataclass(frozen=True)
class LeastLoadedRouter(RouterPolicy):
    def pick(self, pool: Sequence[int], loads: Sequence[int], rid: int) -> int:
        return min(pool, key=lambda c: (loads[c], c))


@dataclass(frozen=True)
class DisaggPrefillRouter(RouterPolicy):
    handoff: bool = True

    def pools(self, n_ccs: int, cfg: SimConfig) -> Tuple[Tuple[int, ...],
                                                         Tuple[int, ...]]:
        if n_ccs < 2:
            raise ValueError(
                f"router {self.name!r} needs n_ccs >= 2 (one CC per pool); "
                f"got n_ccs={n_ccs}")
        n_p = min(n_ccs - 1,
                  max(1, round(n_ccs * cfg.serving_prefill_frac)))
        ccs = tuple(range(n_ccs))
        return ccs[:n_p], ccs[n_p:]

    def pick(self, pool: Sequence[int], loads: Sequence[int], rid: int) -> int:
        return min(pool, key=lambda c: (loads[c], c))


_ROUTERS: Dict[str, RouterPolicy] = {}


def register_router(router: RouterPolicy, *, overwrite: bool = False) -> RouterPolicy:
    """Register a :class:`RouterPolicy` under its ``name`` (mirrors the
    policy/workload registries; duplicate names raise unless overwrite)."""
    if not isinstance(router, RouterPolicy):
        raise TypeError(f"register_router needs a RouterPolicy, got {router!r}")
    if router.name in _ROUTERS and not overwrite:
        raise ValueError(
            f"router {router.name!r} already registered "
            f"(pass overwrite=True to replace)")
    _ROUTERS[router.name] = router
    return router


def unregister_router(name: str) -> None:
    _ROUTERS.pop(name, None)


def get_router(name) -> RouterPolicy:
    """Resolve a router by name; unknown names fail fast listing choices."""
    if isinstance(name, RouterPolicy):
        return name
    r = _ROUTERS.get(name)
    if r is None:
        raise KeyError(
            f"unknown router {name!r}; registered routers: "
            f"{', '.join(available_routers())}")
    return r


def available_routers() -> Tuple[str, ...]:
    return tuple(_ROUTERS)


register_router(RoundRobinRouter(
    name="round_robin",
    description="rid % pool: all phases on the arrival CC"))
register_router(LeastLoadedRouter(
    name="least_loaded",
    description="fewest busy+queued phases (ties: lowest CC index); all "
                "phases on the arrival CC"))
register_router(DisaggPrefillRouter(
    name="disagg_prefill",
    description="prefill-specialized and decode-specialized CC pools "
                "(serving_prefill_frac split); decode phases re-fetch the "
                "MC-resident KV pages cold"))


# --------------------------------------------------------------------------
# scheduler
# --------------------------------------------------------------------------


def _empty_trace() -> Trace:
    z = np.zeros(0, np.int64)
    return (z, z, np.zeros(0, bool))


class ServingScheduler:
    """Open-loop request scheduler over one :class:`Simulator` instance.

    Cores bootstrap with empty traces and report idle at t=0; arrivals are
    engine events; the engine's ``on_core_idle`` hook drives phase
    transitions (next decode step, pool handoff, or request completion).
    All scheduling state is deterministic given (cfg, scheme, seed)."""

    def __init__(self, cfg: SimConfig, scheme, *, seed: int = 0):
        if cfg.serving_router is None:
            raise ValueError("ServingScheduler needs cfg.serving_router set "
                             "(see available_routers())")
        self.cfg = cfg
        self.router = get_router(cfg.serving_router)
        n_ccs = max(1, cfg.n_ccs)
        self.prefill_pool, self.decode_pool = self.router.pools(n_ccs, cfg)
        self.requests = build_requests(cfg, seed)
        self.records = [RequestRecord(rid=r.rid, arrival=r.arrival)
                        for r in self.requests]

        base_pol = get_policy(scheme)
        pre_over, dec_over = cfg.serving_prefill_policy, cfg.serving_decode_policy
        if (pre_over or dec_over) and not self.router.handoff:
            raise ValueError(
                "per-pool policy overrides (serving_prefill_policy / "
                "serving_decode_policy) need a disaggregated router with "
                f"disjoint pools; router {self.router.name!r} shares CCs")
        pre_ctrl = cfg.serving_prefill_controller
        dec_ctrl = cfg.serving_decode_controller
        if (pre_ctrl or dec_ctrl) and not self.router.handoff:
            raise ValueError(
                "per-pool controller overrides (serving_prefill_controller /"
                " serving_decode_controller) need a disaggregated router "
                f"with disjoint pools; router {self.router.name!r} shares CCs")
        pset = set(self.prefill_pool)
        if pre_over or dec_over or pre_ctrl or dec_ctrl:
            pp = get_policy(pre_over) if pre_over else base_pol
            dp = get_policy(dec_over) if dec_over else base_pol
            if pre_ctrl:
                pp = pp.with_(controller=pre_ctrl)
            if dec_ctrl:
                dp = dp.with_(controller=dec_ctrl)
            policies: object = [pp if c in pset else dp for c in range(n_ccs)]
        else:
            policies = base_pol

        # per-CC workload labels drive each CC's compressibility model:
        # disaggregated pools are labeled by their phase, shared pools by
        # the decode workload (decode slices dominate the request count)
        if self.router.handoff:
            cc_workloads = [cfg.prefill_workload if c in pset
                            else cfg.decode_workload for c in range(n_ccs)]
        else:
            cc_workloads = [cfg.decode_workload] * n_ccs
        workload = "+".join(cc_workloads) if n_ccs > 1 else cc_workloads[0]

        # one shared per-CC footprint spanning every phase trace: requests
        # replay overlapping windows of the same captured streams, so the
        # local page cache models a shared (KV-page) working set
        fp = max(int(tr[1].max()) + 64
                 for r in self.requests for tr in r.phases)
        groups = [[_empty_trace() for _ in range(cfg.n_cores)]
                  for _ in range(n_ccs)]
        self.sim = Simulator(cfg, policies, groups, workload=workload,
                             seed=seed, footprints=[fp] * n_ccs)
        self.sim.on_core_idle = self._on_idle

        self._idle: List[List[Core]] = [[] for _ in range(n_ccs)]
        self._queues: List[deque] = [deque() for _ in range(n_ccs)]
        self._core_job: Dict[int, Tuple[RequestSpec, int]] = {}

    # -- state --
    def _loads(self) -> List[int]:
        n_cores = self.cfg.n_cores
        return [(n_cores - len(self._idle[c])) + len(self._queues[c])
                for c in range(len(self._idle))]

    # -- scheduling --
    def _arrive(self, req: RequestSpec, t: float):
        rec = self.records[req.rid]
        cc = self.router.pick(self.prefill_pool, self._loads(), req.rid)
        rec.prefill_cc = cc
        self._submit(cc, req, 0, t)

    def _submit(self, cc: int, req: RequestSpec, phase: int, t: float):
        if self._idle[cc]:
            self._start(self._idle[cc].pop(), req, phase, t)
        else:
            self._queues[cc].append((req, phase, t))

    def _start(self, core: Core, req: RequestSpec, phase: int, t: float):
        rec = self.records[req.rid]
        if phase == 0 and math.isnan(rec.t_start):
            rec.t_start = t
        self._core_job[core.cid] = (req, phase)
        gaps, addrs, writes = req.phases[phase]
        core.gaps = gaps
        core.addrs = addrs >> 6  # byte addrs -> line addrs (as Simulator)
        core.writes = writes
        core.idx = 0
        core.draining = False
        self.sim.eng.at(t, lambda tt, c=core: self.sim.core_step(c, tt))

    def _park(self, core: Core, t: float):
        q = self._queues[core.cc]
        if q:
            # a core can report idle at its own clock, which may lie before
            # the cycle the queued phase became ready (core_step runs a core
            # ahead of the event clock): start no earlier than that cycle
            req, phase, t_ready = q.popleft()
            self._start(core, req, phase, max(t, t_ready))
            return
        lst = self._idle[core.cc]
        if core not in lst:
            lst.append(core)

    def _on_idle(self, core: Core, t: float):
        job = self._core_job.pop(core.cid, None)
        if job is None:  # bootstrap idle (empty initial trace)
            self._park(core, t)
            return
        req, phase = job
        rec = self.records[req.rid]
        last = phase == len(req.phases) - 1
        if phase == 0:
            rec.t_prefill_done = t
        if last:
            rec.t_done = t
            self._park(core, t)
            return
        if phase == 0 and self.router.handoff:
            # prefill done: free the prefill slot, hand the request to the
            # decode pool (its local cache is cold for the KV pages — the
            # handoff cost is the re-fetch through the contended links)
            self._park(core, t)
            cc = self.router.pick(self.decode_pool, self._loads(), req.rid)
            rec.decode_cc = cc
            self._submit(cc, req, 1, t)
            return
        if phase == 0:
            rec.decode_cc = core.cc
        self._start(core, req, phase + 1, t)

    # -- run / rollup --
    def run(self) -> Metrics:
        eng = self.sim.eng
        for req in self.requests:
            eng.at(req.arrival, lambda t, r=req: self._arrive(r, t))
        m = self.sim.run(until=self.cfg.serving_horizon)
        self._rollup(m)
        return m

    def _rollup(self, m: Metrics):
        done = [rec for rec in self.records if rec.completed]
        m.requests_offered = self.cfg.n_requests
        m.requests_completed = len(done)
        if done:
            lats = np.array([rec.latency for rec in done])
            m.request_p50 = float(np.percentile(lats, 50))
            m.request_p99 = float(np.percentile(lats, 99))
        makespan = max(m.cycles, 0.0)
        m.goodput = len(done) / makespan * 1e6 if makespan > 0 else 0.0
        m.requests = [rec.as_dict() for rec in self.records]


def serve_one(cfg: SimConfig, scheme, *, seed: int = 0) -> Metrics:
    """One open-loop serving cell (the ``run_one`` of §2.9): build the
    request set, schedule it through ``cfg.serving_router``, and return
    Metrics with the request-level rollup populated."""
    return ServingScheduler(cfg, scheme, seed=seed).run()
