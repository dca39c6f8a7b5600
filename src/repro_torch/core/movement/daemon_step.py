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
write the residual, the moments and the master in place.

On a mesh (``runtime/sharding.py``) the master, moments and residual are
DTensors laid out as the parameters.  Whether a leaf is page class or
foldable is decided on its global shape, as JAX decides it; K1/K2 are fed
rank-local blocks: a shard whose last dim the 128-blocks tile from a block
boundary is quantised where it lies, any other is first laid out so that its
last dim is whole on every rank (``block_layout``), quantised there, and
placed back, as GSPMD does around the Pallas call.  The codes, scales and
residual are then the one-device run's.
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
from repro_torch.runtime.sharding import from_block


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


def block_layout(x) -> tuple:
    """Placements of the DTensor ``x`` under which every rank holds whole
    128-blocks of the last dim: ``x``'s own where its last-dim shards are
    block multiples, else each mesh dim that splits the last dim moved to the
    first leading dim it divides, or to ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl, last = x.device_mesh, list(x.placements), x.ndim - 1
    on_last = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == last]
    n_last = 1
    for i in on_last:
        n_last *= mesh.size(i)
    if (x.shape[-1] // n_last) % bq.BLOCK == 0:
        return tuple(pl)
    for i in on_last:
        pl[i] = Replicate()
        for d in range(last):
            split = mesh.size(i)
            for j, p in enumerate(pl):
                if isinstance(p, Shard) and p.dim == d:
                    split *= mesh.size(j)
            if x.shape[d] % split == 0:
                pl[i] = Shard(d)
                break
    return tuple(pl)


def _on_blocks(fn: Callable, x: torch.Tensor):
    """``fn`` applied to the rank-local blocks of the DTensor ``x`` laid out
    by :func:`block_layout`; its outputs (of the local shape) come back as
    DTensors in ``x``'s placements."""
    lay = block_layout(x)
    xl = x.redistribute(x.device_mesh, lay) if lay != tuple(x.placements) else x
    outs = fn(xl.to_local())
    back = []
    for o in outs:
        d = from_block(o, x.device_mesh, lay, x.shape)
        back.append(d.redistribute(x.device_mesh, x.placements) if lay != tuple(x.placements)
                    else d)
    return back


def _int8_roundtrip(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    q, s = bq.quantize(x)
    return bq.dequantize(q, s, dtype)


def _copy_leaf(p: torch.Tensor, cfg_mv: MovementConfig) -> torch.Tensor:
    if cfg_mv.expert_weights == "int8" and is_page_class(tuple(p.shape)):
        # page-class tensors (stacked expert/layer weights): int8 wire
        if nn.is_dtensor(p):
            return _on_blocks(lambda x: (_int8_roundtrip(x.to(torch.float32), torch.bfloat16),),
                              p)[0]
        return _int8_roundtrip(p.to(torch.float32), torch.bfloat16)
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
        residual=nn.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), master),
    )


def init_abstract(master: Any) -> DaemonState:
    """The shapes and dtypes of ``init_state(master)``'s leaves."""
    LeafShape = adamw.LeafShape
    res = nn.tree_map(lambda p: LeafShape(tuple(p.shape), torch.float32), master)
    return DaemonState(adam=adamw.init_abstract(master),
                       master=nn.tree_map(lambda p: LeafShape(tuple(p.shape), p.dtype), master),
                       residual=res)


def state_shardings(psh: Any, replicated=None) -> DaemonState:
    """Sharding tree matching :func:`init_abstract` (``psh``: the parameters'
    shardings).  The step count is ``replicated``: ``None`` keeps it a plain
    tensor, the same on every rank."""
    return DaemonState(
        adam=adamw.AdamWState(replicated, psh, psh),
        master=psh,
        residual=psh,
    )


def fold(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Error feedback: the gradient plus the residual crosses the link int8;
    what the round trip dropped is written into ``r`` for the next step.
    Returns the f32 gradient that arrived."""
    g32 = g.to(torch.float32) + r
    if is_foldable(tuple(g32.shape)):
        if nn.is_dtensor(g32):
            def local(x):
                deq = _int8_roundtrip(x, torch.float32)
                return deq, x - deq

            deq, res = _on_blocks(local, g32)
            r.to_local().copy_(res.to_local())
            return deq
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
