"""Step functions (port of ``repro.launch.steps``): the train step (forward +
backward + AdamW) and the two serving steps (prefill / decode).  The
``movement`` argument selects the data-movement scheme for gradients and
parameters:

  "baseline" — f32 parameters and gradients, AdamW state mirroring them.
  "daemon"   — the paper's engine (core/movement): f32 master in the state,
               a bf16 (or int8 round-tripped) working copy, optional int8
               gradients with error feedback.

Where JAX's train step is a pure function of donated buffers, the port's
writes the optimizer state and master in place (``optim.adamw.update``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import nn
from repro_torch.optim import adamw, schedule


def auto_microbatches(cfg: ModelConfig, seq_len: int, global_batch: int, n_dp: int,
                      budget_bytes: float = 6e9) -> int:
    """Pick the gradient-accumulation factor so the per-device activation
    stash (~2.5 bytes/elem x layers x local tokens x d_model: the residual
    saved per layer plus policy-saved dot outputs) fits the budget.
    Power of two, at most one sequence per microbatch per DP shard."""
    local_batch = max(1, global_batch // max(n_dp, 1))
    layers = cfg.num_layers + cfg.enc_layers + cfg.dec_layers
    stash = 2.5 * layers * local_batch * seq_len * cfg.d_model
    k = 1
    while stash / k > budget_bytes and k < local_batch:
        k *= 2
    return k


def dp_degree(mesh) -> int:
    """The data-parallel degree of ``mesh`` (a ``DeviceMesh`` or
    ``MeshShape``): its size over the ``model`` axis, as JAX's dry run passes
    ``n_dp`` to :func:`auto_microbatches`."""
    from repro_torch.launch.mesh import axis_names, axis_size

    names = axis_names(mesh)
    n = 1
    for a in names:
        n *= axis_size(mesh, a)
    return n // (axis_size(mesh, "model") if "model" in names else 1)


def _split_microbatches(x: torch.Tensor, k: int) -> list:
    """``x``'s k microbatches along dim 0.  A DTensor batch (sharded on dim 0)
    splits each rank's local rows, so every microbatch stays sharded as the
    batch: the microbatches hold other rows than on one device, and their
    mean is the same."""
    if nn.is_dtensor(x):
        from torch.distributed.tensor import DTensor

        parts = x.to_local().reshape(k, -1, *x.shape[1:])
        return [DTensor.from_local(p, x.device_mesh, x.placements, run_check=False)
                for p in parts]
    return list(x.reshape(k, x.shape[0] // k, *x.shape[1:]))


def _value_and_grad(cfg: ModelConfig, params, batch):
    """(grads in the parameters' dtypes, metrics) of ``M.loss_fn``.  On a
    mesh each gradient is laid out as its parameter (the data-parallel
    reduction) and the metrics are plain tensors, the same on every rank."""
    leaves = [p.detach().requires_grad_() for p in nn.tree_leaves(params)]
    with torch.enable_grad(), nn.mesh_context():
        loss, metrics = M.loss_fn(cfg, nn.tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    if nn.is_dtensor(loss):
        with torch.no_grad():
            grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
        metrics = {k: v.full_tensor() if nn.is_dtensor(v) else v for k, v in metrics.items()}
    return nn.tree_unflatten(params, list(grads)), metrics


def _microbatched_grads(cfg: ModelConfig, params, batch, k: int):
    """Mean loss/grads over k sequential microbatches (activation stash /k):
    grads summed in f32 and divided by k, the last microbatch's metrics, and
    the mean loss."""
    if k <= 1:
        return _value_and_grad(cfg, params, batch)

    mb = {key: _split_microbatches(x, k) for key, x in batch.items()}
    g_sum = nn.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=nn.tree_leaves(params)[0].device)
    for i in range(k):
        grads, metrics = _value_and_grad(cfg, params, {key: x[i] for key, x in mb.items()})
        with torch.no_grad():
            nn.tree_map(lambda a, g: a.add_(g.to(torch.float32)), g_sum, grads)
        loss_sum = loss_sum + metrics["loss"]
    with torch.no_grad():
        grads = nn.tree_map(lambda g: g / k, g_sum)
    metrics = dict(metrics, loss=loss_sum / k)
    return grads, metrics


def make_train_step(
    cfg: ModelConfig,
    *,
    peak_lr: float = 3e-4,
    total_steps: int = 10_000,
    movement: str = "baseline",
    movement_cfg: Optional[Any] = None,
    num_microbatches: int = 1,
) -> Callable:
    warmup = max(1, min(100, total_steps // 10))
    sched = schedule.make(
        cfg.schedule, peak_lr=peak_lr, total_steps=total_steps, warmup_steps=warmup
    )

    if movement == "daemon":
        from repro_torch.core import movement as mv

        return mv.make_daemon_train_step(
            cfg, sched=sched, engine_cfg=movement_cfg, num_microbatches=num_microbatches
        )

    def train_step(params, opt_state, batch):
        grads, metrics = _microbatched_grads(cfg, params, batch, num_microbatches)
        lr = sched(opt_state.step)
        params, opt_state, om = adamw.update(grads, opt_state, params, lr)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        with nn.mesh_context():
            return M.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def decode_step(params, cache, token, pos: int):
        with nn.mesh_context():
            logits, cache = M.decode_step(cfg, params, cache, token, pos)
        if nn.is_dtensor(logits):  # (B, V): gathered whole on every rank
            logits = logits.full_tensor()
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step
