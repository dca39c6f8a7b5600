"""Data-movement engine configuration + the selection-granularity unit.

``MovementConfig`` is the TPU analogue of DaeMon's per-CC hardware config:
what the page class is compressed to, how bulk collectives are chunked, and
how much of each tensor rides the critical (sub-block) path.

``SelectionUnit`` is the paper's adaptive controller (§3-II) at the host
level: it watches the three roofline terms / measured step phases (the
"inflight buffer utilizations" of the TPU fabric) and picks the movement
config.  Decisions are hysteretic; a config change re-specializes the
compiled step (compile cache keyed on the config tuple), so flapping is
explicitly damped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class MovementConfig:
    # page-class (bulk) movement
    param_gather: str = "bf16"  # f32 | bf16 | int8  — working-copy precision
    grad_sync: str = "bf16"  # f32 | bf16 | int8 (int8 => error feedback)
    expert_weights: str = "bf16"  # serving: int8 page-class expert/mlp weights
    page_chunks: int = 4  # bulk collective split factor (overlap granularity)
    # sub-block (critical) movement
    critical_rows: int = 0  # rows gathered first, uncompressed
    lines_per_page: int = 16  # nominal bandwidth partition ratio (doc'd knob)

    def cache_key(self) -> Tuple:
        return (
            self.param_gather, self.grad_sync, self.expert_weights,
            self.page_chunks, self.critical_rows,
        )


BASELINE = MovementConfig(param_gather="f32", grad_sync="f32", expert_weights="f32",
                          page_chunks=1, critical_rows=0)
DAEMON_DEFAULT = MovementConfig()
DAEMON_AGGRESSIVE = MovementConfig(grad_sync="int8", expert_weights="int8", page_chunks=8)


@dataclass
class SelectionUnit:
    """Hysteresis controller: collective-pressure signal -> MovementConfig.

    The signal is the collective roofline term divided by the compute term
    (dry-run: from launch.roofline; real HW: measured async-transfer time /
    step time).  High pressure -> compress harder + chunk more (pages are the
    bottleneck); low pressure -> back off to cheaper uncompressed movement
    (the paper's "schedule more pages under low bandwidth utilization").
    """

    hi: float = 1.0  # collective/compute ratio above which to escalate
    lo: float = 0.25  # ratio below which to relax
    hold_steps: int = 20  # hysteresis: min steps between changes
    _level: int = 1  # 0=baseline-ish, 1=default, 2=aggressive
    _last_change: int = -10**9
    history: list = field(default_factory=list)

    LEVELS = (
        MovementConfig(param_gather="bf16", grad_sync="bf16", page_chunks=1),
        DAEMON_DEFAULT,
        DAEMON_AGGRESSIVE,
    )

    def config(self) -> MovementConfig:
        return self.LEVELS[self._level]

    def observe(self, step: int, collective_s: float, compute_s: float) -> MovementConfig:
        ratio = collective_s / max(compute_s, 1e-12)
        self.history.append((step, ratio, self._level))
        if step - self._last_change >= self.hold_steps:
            if ratio > self.hi and self._level < 2:
                self._level += 1
                self._last_change = step
            elif ratio < self.lo and self._level > 0:
                self._level -= 1
                self._last_change = step
        return self.config()
