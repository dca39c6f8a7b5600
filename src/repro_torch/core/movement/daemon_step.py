"""The DaeMon-integrated training step (port of
``repro.core.movement.daemon_step``): mixed precision with page-class link
compression, on one device.

  * the f32 MASTER parameters live in the optimizer state;
  * the forward/backward runs on a bf16 WORKING copy;
  * gradients arrive in bf16;
  * with ``grad_sync="int8"``, each gradient the int8 blocks tile (ndim >= 2,
    last dim a multiple of 128) crosses the "link" int8-compressed: kernels
    K1 (quantize) and K2 (dequantize) on the card, with an f32 error-feedback
    residual carried in the state and folded into the next step;
  * under ``expert_weights="int8"`` every stacked page-class weight of the
    new working copy makes the same int8 round trip.

JAX's step is a pure function over donated buffers; here the fold, the
AdamW update and the new working copy run under ``torch.no_grad()`` and
write the residual, the moments and the master in place.  The collectives of
a sharded step (``collectives.py``) vanish on one device, as GSPMD's do.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core.movement.engine import DAEMON_DEFAULT, MovementConfig
from repro_torch.kernels.block_quant import ops as bq
from repro_torch.models import nn
from repro_torch.optim import adamw


class DaemonState(NamedTuple):
    adam: adamw.AdamWState  # m, v, step, f32
    master: Any  # f32 master params
    residual: Any  # error-feedback residual (zeros unless grad_sync="int8")


def is_page_class(shape: tuple[int, ...]) -> bool:
    """Whether a master tensor of this shape is page class: stacked (ndim >= 3)
    with a last dim the int8 blocks tile."""
    return len(shape) >= 3 and shape[-1] % 128 == 0


def is_foldable(shape: tuple[int, ...]) -> bool:
    """Whether a gradient of this shape crosses the link int8: ndim >= 2 with
    a last dim the int8 blocks tile."""
    return len(shape) >= 2 and shape[-1] % 128 == 0


def _copy_leaf(p: torch.Tensor, cfg_mv: MovementConfig) -> torch.Tensor:
    if cfg_mv.expert_weights == "int8" and is_page_class(tuple(p.shape)):
        # page-class tensors (stacked expert/layer weights): int8 wire
        q, s = bq.quantize(p.to(torch.float32))
        return bq.dequantize(q, s, torch.bfloat16)
    return p.to(torch.bfloat16)


def working_copy(master: Any, cfg_mv: MovementConfig) -> Any:
    """bf16 (or int8-roundtripped) working parameters from the f32 master."""
    return nn.tree_map(lambda p: _copy_leaf(p, cfg_mv), master)


def init_working_copy(specs: Any, generator: torch.Generator, device: torch.device,
                      cfg_mv: MovementConfig) -> Any:
    """``working_copy(nn.init_params(specs, generator, device), cfg_mv)``,
    equal to it bit for bit, without the f32 master: each leaf is drawn as
    ``init_params`` draws it, in the same order from the same generator,
    copied, and released.  For serving, which never reads the master again:
    the peak is the working copy plus the largest f32 leaf and its int8 codes,
    not the master beside the copy."""
    return nn.init_params(specs, generator, device, then=lambda p: _copy_leaf(p, cfg_mv))


def init_state(master: Any) -> DaemonState:
    return DaemonState(
        adam=adamw.init(master),
        master=master,
        residual=nn.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), master),
    )


def fold(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Error feedback: the gradient plus the residual crosses the link int8;
    what the round trip dropped is written into ``r`` for the next step.
    Returns the f32 gradient that arrived."""
    g32 = g.to(torch.float32) + r
    if is_foldable(tuple(g32.shape)):
        q, s = bq.quantize(g32)
        deq = bq.dequantize(q, s, torch.float32)
        torch.sub(g32, deq, out=r)
        return deq
    r.zero_()
    return g32


def make_daemon_train_step(
    cfg: ModelConfig,
    *,
    sched: Callable,
    engine_cfg: Optional[MovementConfig] = None,
    num_microbatches: int = 1,
) -> Callable:
    mv = engine_cfg or DAEMON_DEFAULT
    from repro_torch.launch.steps import _microbatched_grads

    def train_step(params_bf16, state: DaemonState, batch):
        # grads are computed against the working copy from the previous step.
        # The named ranges let a profile split the step (the backward runs on
        # autograd's own thread, outside the first range).
        with record_function("daemon_step.grads"):
            grads, metrics = _microbatched_grads(cfg, params_bf16, batch, num_microbatches)
        with torch.no_grad():
            if mv.grad_sync == "int8":
                with record_function("daemon_step.fold"):
                    grads = nn.tree_map(fold, grads, state.residual)
            with record_function("daemon_step.adamw"):
                lr = sched(state.adam.step)
                master, adam_state, om = adamw.update(grads, state.adam, state.master, lr)
            with record_function("daemon_step.working_copy"):
                new_params = working_copy(master, mv)
        return new_params, DaemonState(adam_state, master, state.residual), {**metrics, **om}

    return train_step
