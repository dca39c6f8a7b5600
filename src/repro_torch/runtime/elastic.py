"""Elastic mesh reconfiguration (a copy of ``repro.runtime.elastic``, which
the port may not import; held field-equal to the original by
tests/test_torch_sharding.py): map a surviving host set onto a new
(pod, data, model) mesh and re-shard the run state.

Policy: TP ("model") degree is pinned (it matches the model's sharded
matrix layouts); elasticity happens on the DP axes — the largest data degree
that divides both the surviving chip count and the global batch is chosen,
spare hosts idle as hot standbys.  Checkpoints are mesh-agnostic (global
arrays), so restore-with-new-shardings IS the re-shard (checkpoint/ckpt.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MeshPlan:
    pods: int
    data: int
    model: int
    used_chips: int
    spare_chips: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.pods > 1 else (self.data, self.model)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")


def plan_mesh(
    n_chips: int, *, model_degree: int = 16, global_batch: int = 256,
    chips_per_pod: int = 256,
) -> MeshPlan:
    """Largest viable (pod, data, model) layout for the surviving chips."""
    if n_chips < model_degree:
        raise ValueError(f"need >= {model_degree} chips for TP, have {n_chips}")
    pods = max(1, n_chips // chips_per_pod)
    while pods > 1 and n_chips // pods < model_degree:
        pods -= 1
    per_pod = n_chips // pods
    data = per_pod // model_degree
    # data degree must divide the global batch (whole sequences per shard)
    while data > 1 and global_batch % (data * pods):
        data -= 1
    used = pods * data * model_degree
    return MeshPlan(pods, data, model_degree, used, n_chips - used)


def replan_after_failure(
    old: MeshPlan, lost_chips: int, global_batch: int = 256
) -> MeshPlan:
    return plan_mesh(
        old.used_chips + old.spare_chips - lost_chips,
        model_degree=old.model,
        global_batch=global_batch,
        chips_per_pod=max(old.data * old.model, 1),
    )
