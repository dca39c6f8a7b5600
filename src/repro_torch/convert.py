"""Load a parameter (or cache) tree held as numpy arrays, such as the JAX
package's, into the port's nested dict of tensors."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import nn


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
