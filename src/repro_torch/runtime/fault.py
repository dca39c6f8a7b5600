"""Fault tolerance + straggler mitigation for 1000+-node operation (a copy
of ``repro.runtime.fault``, which the port may not import; held field-equal
to the original by tests/test_torch_train.py).

Components (single-process-testable; the same state machines drive a real
multi-host deployment through torch.distributed + the launcher):

  HeartbeatMonitor  — per-host liveness from periodic beats; marks hosts
                      SUSPECT after ``suspect_after`` missed intervals and
                      DEAD after ``dead_after`` (failure detector φ-style,
                      simplified to fixed windows).
  StragglerPolicy   — per-step host timing ring buffer; escalation ladder:
                      observe -> rebalance (shrink slow host's data shard) ->
                      exclude (drop + reweight) -> evict (trigger elastic
                      restart).  Hysteresis prevents flapping.
  RunSupervisor     — ties them together with the CheckpointManager: on a
                      DEAD host or an EVICT decision it requests an elastic
                      restart from the latest checkpoint with the surviving
                      host set (runtime/elastic.py computes the new mesh).

Tests inject synthetic beats/timings.
"""
from __future__ import annotations

import enum
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple


class HostState(enum.Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass
class HeartbeatMonitor:
    interval_s: float = 10.0
    suspect_after: int = 2  # missed intervals
    dead_after: int = 6
    last_beat: Dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_beat[host] = time.time() if now is None else now

    def state(self, host: int, now: Optional[float] = None) -> HostState:
        now = time.time() if now is None else now
        t = self.last_beat.get(host)
        if t is None:
            return HostState.DEAD
        missed = (now - t) / self.interval_s
        if missed >= self.dead_after:
            return HostState.DEAD
        if missed >= self.suspect_after:
            return HostState.SUSPECT
        return HostState.ALIVE

    def dead_hosts(self, hosts: List[int], now: Optional[float] = None) -> List[int]:
        return [h for h in hosts if self.state(h, now) == HostState.DEAD]


class Action(enum.Enum):
    NONE = "none"
    REBALANCE = "rebalance"  # shrink the slow host's data shard
    EXCLUDE = "exclude"  # drop its gradient contribution + reweight
    EVICT = "evict"  # remove from the job -> elastic restart


@dataclass
class StragglerPolicy:
    window: int = 20  # steps of history per host
    slow_ratio: float = 1.3  # step_time / median above which a host is slow
    rebalance_after: int = 5  # consecutive slow steps before acting
    exclude_after: int = 15
    evict_after: int = 40
    _hist: Dict[int, deque] = field(default_factory=lambda: defaultdict(lambda: deque(maxlen=64)))
    _slow_streak: Dict[int, int] = field(default_factory=lambda: defaultdict(int))

    def observe_step(self, times: Dict[int, float]) -> Dict[int, Action]:
        """times: host -> step wall time.  Returns per-host actions."""
        if not times:
            return {}
        med = sorted(times.values())[len(times) // 2]
        out: Dict[int, Action] = {}
        for h, t in times.items():
            self._hist[h].append(t)
            if med > 0 and t / med >= self.slow_ratio:
                self._slow_streak[h] += 1
            else:
                self._slow_streak[h] = 0
            s = self._slow_streak[h]
            if s >= self.evict_after:
                out[h] = Action.EVICT
            elif s >= self.exclude_after:
                out[h] = Action.EXCLUDE
            elif s >= self.rebalance_after:
                out[h] = Action.REBALANCE
            else:
                out[h] = Action.NONE
        return out


@dataclass
class RunSupervisor:
    hosts: List[int]
    monitor: HeartbeatMonitor = field(default_factory=HeartbeatMonitor)
    policy: StragglerPolicy = field(default_factory=StragglerPolicy)
    on_elastic_restart: Optional[Callable[[List[int]], None]] = None
    excluded: Set[int] = field(default_factory=set)
    events: List[Tuple[str, int]] = field(default_factory=list)

    def tick(self, step_times: Dict[int, float], now: Optional[float] = None) -> Optional[List[int]]:
        """One supervision round.  Returns the new host list if an elastic
        restart is required, else None."""
        dead = set(self.monitor.dead_hosts(self.hosts, now))
        for h in dead:
            self.events.append(("dead", h))
        actions = self.policy.observe_step(
            {h: t for h, t in step_times.items() if h not in dead}
        )
        evict = {h for h, a in actions.items() if a == Action.EVICT}
        for h, a in actions.items():
            if a == Action.EXCLUDE and h not in self.excluded:
                self.excluded.add(h)
                self.events.append(("exclude", h))
            elif a == Action.REBALANCE:
                self.events.append(("rebalance", h))
        removed = dead | evict
        if removed:
            survivors = [h for h in self.hosts if h not in removed]
            self.hosts = survivors
            self.excluded -= removed
            for h in evict:
                self.events.append(("evict", h))
            if self.on_elastic_restart:
                self.on_elastic_restart(survivors)
            return survivors
        return None
