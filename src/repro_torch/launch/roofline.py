"""Roofline terms of a dry-run step (port of ``repro.launch.roofline``), in
seconds per step per card over the NVIDIA H100 SXM's published peaks:

  compute    = FLOPs_per_device / BF16_FLOP_PER_S
  memory     = HBM_bytes_per_device / HBM_BYTES_PER_S
  collective = collective_operand_bytes_per_device / NVLINK_BYTES_PER_S

The peaks are NVIDIA's data sheet's (dense, at the 700 W limit), not
measurements: a card set below 700 W runs slower under load, so quote its
``power.limit`` beside any share of these.  The counts come from the op
counter (``launch/hlo_cost.py``), not from a compiled module: JAX's
``parse_collectives`` and ``xla_raw_cost`` read XLA's objects and have no
counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
F32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores
SMS = 132  # streaming multiprocessors
# NVLink 4 per direction: half the data sheet's 900 GB/s, which counts both
NVLINK_BYTES_PER_S = 450e9


@dataclass
class CollectiveStats:
    operand_bytes: Dict[str, int] = field(default_factory=dict)  # kind -> bytes
    result_bytes: Dict[str, int] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    def wire_bytes(self) -> int:
        """Ring estimate: all-reduce moves ~2x its operand; others ~1x."""
        total = 0
        for kind, b in self.operand_bytes.items():
            total += 2 * b if kind == "all-reduce" else b
        return total


@dataclass
class Roofline:
    flops: float  # per-device FLOPs
    hbm_bytes: float  # per-device bytes accessed
    collective_bytes: float  # per-device collective operand bytes
    wire_bytes: float
    n_devices: int

    @property
    def t_compute(self) -> float:
        return self.flops / BF16_FLOP_PER_S

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "wire_bytes": self.wire_bytes,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def analyze(counts: Dict, n_devices: int) -> Tuple[Roofline, CollectiveStats]:
    """The terms of one rank's counts (``hlo_cost.OpCounter.counts()``)."""
    stats = CollectiveStats(
        operand_bytes={k: int(v) for k, v in counts["collective_bytes"].items()},
        result_bytes={},
        counts=dict(counts["collective_counts"]),
    )
    rl = Roofline(
        flops=float(counts["flops"]),
        hbm_bytes=float(counts["hbm_bytes"]),
        collective_bytes=float(stats.total_operand_bytes),
        wire_bytes=float(stats.wire_bytes()),
        n_devices=n_devices,
    )
    return rl, stats


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens/step.
    For decode cells D = global_batch (one token each); attention extra
    ~12*L*d_head*H*S*D is NOT counted (keeps the published convention)."""
    from repro_torch.models import model as M

    n = M.param_count(cfg, active_only=(cfg.family == "moe"))
    if cell.kind == "train":
        d = cell.global_batch * cell.seq_len
        return 6.0 * n * d
    if cell.kind == "prefill":
        d = cell.global_batch * cell.seq_len
        return 2.0 * n * d  # forward only
    d = cell.global_batch  # decode: one token per sequence
    return 2.0 * n * d
