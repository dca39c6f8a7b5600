"""Load a parameter, cache or optimizer-state tree held as numpy arrays, such
as the JAX package's, into the port's nested dicts of tensors."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.movement.daemon_step import DaemonState
from repro_torch.models import nn
from repro_torch.optim.adamw import AdamWState


def params_from_numpy(tree: Any, device, dtype: Optional[torch.dtype] = None) -> Any:
    """Each leaf becomes a tensor on ``device``, cast to ``dtype`` if given.
    A bfloat16 leaf (``ml_dtypes``' type, which ``torch.from_numpy`` rejects)
    is widened to f32, which is exact, and comes back as ``torch.bfloat16``."""

    def one(a) -> torch.Tensor:
        a = np.asarray(a)
        target = dtype
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
            target = target or torch.bfloat16
        # a copy: the source may be a read-only view of another framework's
        # buffer, and the port writes some trees (KV caches) in place
        t = torch.from_numpy(np.array(a, copy=True, order="C")).to(device)
        return t.to(target) if target is not None else t

    return nn.tree_map(one, tree)


def adamw_state_from_numpy(state: Any, device) -> AdamWState:
    """An AdamW state with fields ``step``, ``m`` and ``v`` (JAX's
    ``AdamWState`` mapped to numpy) as the port's."""
    return AdamWState(torch.tensor(np.asarray(state.step), dtype=torch.int32, device=device),
                      params_from_numpy(state.m, device), params_from_numpy(state.v, device))


def daemon_state_from_numpy(state: Any, device) -> DaemonState:
    """A DaeMon training state with fields ``adam``, ``master`` and
    ``residual`` (JAX's ``DaemonState`` mapped to numpy) as the port's."""
    return DaemonState(adamw_state_from_numpy(state.adam, device),
                       params_from_numpy(state.master, device),
                       params_from_numpy(state.residual, device))
