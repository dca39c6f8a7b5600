"""The traced part of a ``--trace 1`` run, and its reduction to what the
per-layer metric readers read.

The profiler runs over a fixed slice of the window's units (steps, batches
or decode steps: the traffic file's ``trace_units``, [first, count]), with
the device synchronised where it starts and where it stops.  The reduction
reads the profiler's raw events (``reduce``, a copy of ``chip_smoke.py``'s
``profile_totals`` widened to every host event and to the device's busy
intervals), since building torch's event list costs about a millisecond a
kernel launch.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TraceSummary:
    """What a reader reads.  ``kernels``: device operation -> [ms, count];
    ``op_ms``: host event (aten op, ``record_function`` range) -> device ms
    of the kernels it and the events nested in it launched; ``busy_s``: the
    union of the device operations' intervals; ``window_s``: host seconds
    from the profiler's start to its stop; ``units``: one dict a traced unit
    (its kind's description and ``wall_s``); ``unattributed``: device
    operation -> ms of the launches no host event could be found for (the
    port's own CUDA libraries link the runtime statically, and the profiler
    sees their kernels run but not their launches); ``spans``: the host
    intervals (ns) of each ``record_function`` range, by name;
    ``busy_intervals``: the device's busy intervals (ns), merged."""

    kernels: Dict[str, list]
    op_ms: Dict[str, float]
    busy_s: float
    window_s: float
    launches: int
    units: List[dict]
    cfg: dict
    traffic: dict
    device_kind: str
    gaps: List[list] = field(default_factory=list)
    unattributed: Dict[str, float] = field(default_factory=dict)
    attributed_via: Dict[str, int] = field(default_factory=dict)
    spans: Dict[str, List[tuple]] = field(default_factory=dict)
    busy_intervals: List[list] = field(default_factory=list)

    def busy_in(self, name: str) -> Tuple[float, float]:
        """(seconds in which an operation ran on the device inside the ranges
        named ``name``, seconds those ranges span), their overlaps merged."""
        spans = _merge(self.spans.get(name, ()))
        return (_overlap_ns(self.busy_intervals, spans) / 1e9,
                sum(e - s for s, e in spans) / 1e9)

    def kernel_ms(self, names) -> float:
        """Device ms of the operations whose names hold one of ``names`` as a
        whole identifier."""
        return sum(ms for k, (ms, _) in self.kernels.items() if matches(k, names))

    def kernel_count(self, names) -> int:
        return sum(n for k, (_, n) in self.kernels.items() if matches(k, names))

    def unattributed_ms(self, names) -> float:
        """Device ms of the operations of ``names`` whose launches no host
        event holds."""
        return sum(ms for k, ms in self.unattributed.items() if matches(k, names))


def matches(kernel: str, names) -> bool:
    import re

    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])", kernel)
               for n in names)


class Tracer:
    """Profiles units first .. first + count - 1 of the window when enabled."""

    def __init__(self, enabled: bool, first: int, count: int, device):
        self.enabled, self.first, self.count, self.device = enabled, first, count, device
        self.index, self.units, self.prof = 0, [], None
        self.window_s: Optional[float] = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def unit(self, **info):
        i = self.index
        self.index += 1
        traced = self.enabled and self.first <= i < self.first + self.count
        if traced and i == self.first:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._t0 = time.perf_counter()
        t0 = time.perf_counter()
        yield info
        if traced:
            self.units.append(dict(info, wall_s=time.perf_counter() - t0))
            if i == self.first + self.count - 1:
                self._sync()
                self.window_s = time.perf_counter() - self._t0
                self.prof.__exit__(None, None, None)

    def stop(self):
        """Close a profile the window ended inside (its units then fall short)."""
        if self.prof is not None and self.window_s is None:
            self._sync()
            self.window_s = time.perf_counter() - self._t0
            self.prof.__exit__(None, None, None)

    @property
    def complete(self) -> bool:
        return self.enabled and len(self.units) == self.count

    @property
    def pending(self) -> bool:
        """Whether traced units are still to come: a traced run's window runs
        on until they have (its end-to-end numbers are not reported)."""
        return self.enabled and len(self.units) < self.count

    def summary(self, cfg: dict, traffic: dict, device_kind: str) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        out = reduce(self.prof)
        return TraceSummary(units=self.units, window_s=self.window_s, cfg=cfg, traffic=traffic,
                            device_kind=device_kind, **out)


def reduce(prof) -> dict:
    """The raw events of ``prof`` -> kernels, op_ms, busy_s, launches, gaps,
    spans, busy_intervals.

    Host events nest by their intervals on one thread (async ones apart), a
    device-runtime event (a launch) on the thread of the host event it links,
    and a parent whose only child has its name takes the child's place, as
    torch's event list builds them.  A device operation's time goes to the
    runtime event that launched it (matched by the runtime's correlation id),
    or, where none matches, to the host event it links; so it counts in every
    host event its launch nests in, launches from outside PyTorch (ctypes)
    included where the profiler records the launch.  ``gaps``: the device's idle time between operations, by what
    the launching thread was inside when each gap began (its outermost and
    innermost host events), summed."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    kernels, host, runtime, thread_of, names, busy, device = {}, [], [], {}, {}, [], []
    spans: Dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        if _filter_name(raw) or getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = _rewrite_name(raw, with_wildcard=True)
        sync = not e.is_async() and e.start_thread_id() == e.end_thread_id()
        link = e.linked_correlation_id()
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            us = (e.end_ns() - e.start_ns()) / 1e3 if sync else 0.0
            acc = kernels.setdefault(name, [0.0, 0])
            acc[0] += us
            acc[1] += 1
            busy.append((e.start_ns(), e.end_ns()))
            device.append((e.correlation_id(), link, us, name))
        elif e.device_type() == cpu and sync:
            # [thread, start, -end, name, op id, launch correlation id]
            row = [e.start_thread_id(), e.start_ns(), -e.end_ns(), name, None, None]
            if link == 0:
                row[4] = e.correlation_id()
                host.append(row)
                thread_of[row[4]] = row[0]
                if "." in name and "::" not in name:  # a record_function range
                    spans.setdefault(name, []).append((e.start_ns(), e.end_ns()))
            else:
                row[5] = e.correlation_id()
                runtime.append((link, row))
    launch_threads: Dict[int, int] = {}
    for link, row in runtime:
        row[0] = thread_of.get(link, row[0])
        launch_threads[row[0]] = launch_threads.get(row[0], 0) + 1
        host.append(row)
    host.sort(key=lambda r: (r[0], r[1], r[2]))
    parent, children, stack = [-1] * len(host), [[] for _ in host], []
    for i, (thread, start, neg_end, *_) in enumerate(host):
        while stack:
            j = stack[-1]
            if host[j][0] != thread or start >= -host[j][2] or -neg_end > -host[j][2]:
                stack.pop()
            else:
                parent[i] = j
                children[j].append(i)
                break
        stack.append(i)
    by_launch = {r[5]: i for i, r in enumerate(host) if r[5] is not None}
    by_op = {r[4]: i for i, r in enumerate(host) if r[4] is not None}
    mine = [0.0] * len(host)
    unattributed, via = {}, {"launch": 0, "link": 0, "none": 0}
    for corr, link, us, name in device:
        i = by_launch.get(corr)
        if i is not None:
            via["launch"] += 1
        else:
            i = by_op.get(link)
            via["link" if i is not None else "none"] += 1
        if i is None:
            unattributed[name] = unattributed.get(name, 0.0) + us / 1e3
        else:
            mine[i] += us
    alive, changed = [True] * len(host), True
    while changed:
        changed = False
        for i, row in enumerate(host):
            j = parent[i]
            if alive[i] and j >= 0 and host[j][3] == row[3] and len(children[j]) == 1:
                children[j], mine[j] = children[i], mine[i]
                for c in children[i]:
                    parent[c] = j
                alive[i], changed = False, True
    total = mine[:]
    for i in range(len(host) - 1, -1, -1):
        if alive[i] and parent[i] >= 0:
            total[parent[i]] += total[i]
    op_ms: Dict[str, float] = {}
    for i, row in enumerate(host):
        if alive[i]:
            op_ms[row[3]] = op_ms.get(row[3], 0.0) + total[i] / 1e3
    main = max(launch_threads, key=launch_threads.get) if launch_threads else None
    merged = _merge(busy)
    busy_ns, gaps = _busy_and_gaps(merged, host, main)
    launches = sum(n for k, (_, n) in kernels.items()
                   if not k.startswith(("Memcpy", "Memset", "cudaMemcpy", "cudaMemset")))
    return {"kernels": {k: [us / 1e3, n] for k, (us, n) in kernels.items()},
            "op_ms": op_ms, "busy_s": busy_ns / 1e9, "launches": launches, "gaps": gaps,
            "unattributed": unattributed, "attributed_via": via, "spans": spans,
            "busy_intervals": merged}


def _merge(intervals) -> List[list]:
    """The union of ``intervals`` as sorted, disjoint [start, end] pairs."""
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_ns(a, b) -> int:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _busy_and_gaps(merged, host, thread):
    """(ns in ``merged``, the device's busy intervals, [[what the host was
    inside, idle seconds]] summed by name, longest first)."""
    busy = sum(e - s for s, e in merged)
    rows = sorted((r[1], -r[2], r[3]) for r in host if r[0] == thread)
    by_name: Dict[str, float] = {}
    stack, k = [], 0
    for (_, end), (start, _) in zip(merged, merged[1:]):
        t = end  # the device went idle here
        while k < len(rows) and rows[k][0] <= t:
            while stack and stack[-1][1] <= rows[k][0]:
                stack.pop()
            stack.append(rows[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            outer, inner = stack[0][2], stack[-1][2]
            what = outer if outer == inner else f"{outer} > {inner}"
        else:
            what = "(no host event)"
        by_name[what] = by_name.get(what, 0.0) + (start - end) / 1e9
    return busy, sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])
