"""Derive a DaeMon-simulator trace ``(gaps, addrs, writes)`` from a kernel's
geometry (port of ``repro.capture.recorder``).

A trace's ``gaps`` are compute cycles between accesses at the simulator's
nominal 3 GHz clock (the simulator prices the memory side itself).  A step's
compute, ``flops_per_step / peak`` seconds, lands as one lump on the step's
first access; the accesses of a tile burst follow back to back (gap 1); a
step that moves nothing carries its compute into the next burst.  Both walks
are deterministic, with no RNG: one geometry gives one trace, bit for bit.

:class:`KernelTraceRecorder` is the JAX package's Pallas walk, with the peak
an argument: given JAX's geometry and JAX's peak it gives JAX's trace.
:class:`CtaTraceRecorder` walks a Hopper launch (:class:`CtaGeometry`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.capture.geometry import (
    CtaGeometry,
    KernelGeometry,
    assign_regions,
    block_line_addrs,
    tile_line_addrs,
)
from repro_torch.launch.roofline import BF16_FLOP_PER_S, F32_FLOP_PER_S

CLOCK_HZ = 3e9  # simulator cycles are a 3 GHz nominal clock (SimConfig)
PEAK_BY_UNIT = {"tensor": BF16_FLOP_PER_S, "cuda": F32_FLOP_PER_S}

Trace = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclass
class CaptureResult:
    """A captured launch: its trace, and the bytes each operand moved (which
    weigh the payload ratios in compress.py)."""

    geom: object  # KernelGeometry or CtaGeometry
    gaps: np.ndarray
    addrs: np.ndarray
    writes: np.ndarray
    regions: Dict[str, int]  # operand -> base byte address
    moved_bytes: Dict[str, int]  # operand -> bytes moved over HBM

    @property
    def trace(self) -> Trace:
        return self.gaps, self.addrs, self.writes

    @property
    def n_accesses(self) -> int:
        return len(self.addrs)

    @property
    def footprint(self) -> int:
        return int(self.addrs.max()) + 64 if len(self.addrs) else 0


class _Stream:
    """The accesses of a walk, grouped by step, with each step's compute."""

    def __init__(self, geom):
        self.regions = assign_regions(geom)
        self.moved = {op.name: 0 for op in geom.operands}
        self.addrs: List[np.ndarray] = []
        self.writes: List[np.ndarray] = []
        self.step_accesses: List[int] = []
        self.step_cycles: List[float] = []

    def move(self, op, lines: np.ndarray, n_bytes: int, write: bool) -> int:
        self.addrs.append(lines)
        self.writes.append(np.full(len(lines), write, bool))
        self.moved[op.name] += n_bytes
        return len(lines)

    def end_step(self, n_acc: int, cycles: float) -> None:
        self.step_accesses.append(n_acc)
        self.step_cycles.append(cycles)

    def result(self, geom) -> CaptureResult:
        addrs = np.concatenate(self.addrs) if self.addrs else np.zeros(0, np.int64)
        writes = np.concatenate(self.writes) if self.writes else np.zeros(0, bool)
        gaps = np.ones(len(addrs), np.int64)
        pos = 0
        carry = 0.0
        for n_acc, cyc in zip(self.step_accesses, self.step_cycles):
            if n_acc == 0:
                carry += cyc
                continue
            gaps[pos] = max(1, int(round(cyc + carry)))
            carry = 0.0
            pos += n_acc
        return CaptureResult(geom=geom, gaps=gaps, addrs=addrs, writes=writes,
                             regions=dict(self.regions), moved_bytes=self.moved)


class KernelTraceRecorder:
    """Walk one :class:`KernelGeometry` in TPU order (last grid axis
    innermost) with Pallas's pipelining contract: an operand's block moves
    only when its index map changes value between steps, and an output block
    is written back when the grid moves off it and at the grid's end."""

    def __init__(self, geom: KernelGeometry, peak_flops: float = BF16_FLOP_PER_S):
        self.geom = geom
        self.peak_flops = peak_flops

    def record(self) -> CaptureResult:
        geom = self.geom
        out = _Stream(geom)
        last_idx: Dict[str, Tuple[int, ...]] = {}

        def move(op, block_idx, write: bool) -> int:
            lines = block_line_addrs(op, out.regions[op.name], block_idx)
            return out.move(op, lines, op.block_nbytes, write)

        step_compute = geom.flops_per_step / self.peak_flops * CLOCK_HZ
        for step in geom.steps():
            n_acc = 0
            for op in geom.operands:
                idx = tuple(int(i) for i in op.index_map(*step))
                prev = last_idx.get(op.name)
                if prev == idx:
                    continue  # block parked in VMEM: no HBM movement
                if op.is_output:
                    if prev is not None:  # write back the block moved off
                        n_acc += move(op, prev, write=True)
                else:
                    n_acc += move(op, idx, write=False)
                last_idx[op.name] = idx
            out.end_step(n_acc, step_compute)
        n_final = 0
        for op in geom.operands:
            if op.is_output and op.name in last_idx:
                n_final += move(op, last_idx[op.name], write=True)
        if n_final:
            out.end_step(n_final, 0.0)
        return out.result(geom)


class CtaTraceRecorder:
    """Walk one :class:`CtaGeometry` as the card runs it, in a deterministic
    model of its CTA scheduler:

    - the first ``n_sms * ctas_per_sm`` CTAs in launch order are resident;
    - each round issues one step of every resident CTA, round-robin in
      launch order;
    - a CTA that has run its last step gives its slot to the next CTA in
      launch order, which starts in the next round;
    - in a step, a CTA issues its input fetches (the ring's ``ahead``
      included) in operand order, then its output writes;
    - a tile a CTA keeps in shared memory or registers across steps (its
      last fetch of that operand) is not fetched again; what other CTAs
      fetch is emitted again, since L2 reuse is the simulator's LLC's to
      model;
    - outputs are written at the step that leaves their tile.

    The card's real CTA order is not deterministic; this model is.  Each step
    carries ``flops_per_step`` at the peak of the geometry's ``flop_unit``:
    summed over the trace, the compute of the whole launch at the card's peak.
    """

    def __init__(self, geom: CtaGeometry):
        self.geom = geom

    def record(self) -> CaptureResult:
        geom = self.geom
        out = _Stream(geom)
        inputs = [op for op in geom.operands if not op.is_output]
        outputs = [op for op in geom.operands if op.is_output]
        step_compute = geom.flops_per_step / PEAK_BY_UNIT[geom.flop_unit] * CLOCK_HZ
        kept: Dict[Tuple[int, str], Tuple[int, ...]] = {}  # (cta, operand) -> last tile

        def move(op, cta: int, idx, write: bool) -> int:
            idx = tuple(int(i) for i in idx)
            if not write:
                if kept.get((cta, op.name)) == idx:
                    return 0
                kept[(cta, op.name)] = idx
            lines = tile_line_addrs(op, out.regions[op.name], idx)
            return out.move(op, lines, op.tile_nbytes(idx), write)

        def run_step(cta: int, step: int) -> None:
            where, n = geom.cta(cta), geom.steps[cta]
            n_acc = 0
            for op in inputs:
                issued = range(min(op.ahead, n - 1) + 1) if step == 0 else (
                    [step + op.ahead] if step + op.ahead < n else [])
                for t in issued:
                    n_acc += move(op, cta, op.index_map(where, t), write=False)
            for op in outputs:
                idx = tuple(op.index_map(where, step))
                if step == n - 1 or tuple(op.index_map(where, step + 1)) != idx:
                    n_acc += move(op, cta, idx, write=True)
            out.end_step(n_acc, step_compute)

        slots = geom.n_sms * geom.ctas_per_sm
        resident = list(range(min(slots, geom.n_ctas)))
        waiting = len(resident)  # the next CTA in launch order
        done = [0] * geom.n_ctas
        while resident:
            for cta in resident:
                run_step(cta, done[cta])
                done[cta] += 1
            still = [c for c in resident if done[c] < geom.steps[c]]
            freed = len(resident) - len(still)
            resident = still + list(range(waiting, min(waiting + freed, geom.n_ctas)))
            waiting = min(waiting + freed, geom.n_ctas)
        return out.result(geom)
