"""The DaeMon working copy (port of ``repro.core.movement.daemon_step``,
``working_copy`` only; the training step comes with the training slice).

The serving weights are a bf16 working copy of the f32 master.  Under
``expert_weights="int8"`` every stacked page-class tensor (ndim >= 3, last
dim a multiple of 128) makes the int8 round trip of DaeMon's link
compression first: kernels K1 (quantize) and K2 (dequantize) on the card.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.movement.engine import MovementConfig
from repro_torch.kernels.block_quant import ops as bq
from repro_torch.models import nn


def is_page_class(shape: tuple[int, ...]) -> bool:
    """Whether a master tensor of this shape is page class: stacked (ndim >= 3)
    with a last dim the int8 blocks tile."""
    return len(shape) >= 3 and shape[-1] % 128 == 0


def working_copy(master: Any, cfg_mv: MovementConfig) -> Any:
    """bf16 (or int8-roundtripped) working parameters from the f32 master."""

    def one(p: torch.Tensor) -> torch.Tensor:
        if cfg_mv.expert_weights == "int8" and is_page_class(tuple(p.shape)):
            # page-class tensors (stacked expert/layer weights): int8 wire
            q, s = bq.quantize(p.to(torch.float32))
            return bq.dequantize(q, s, torch.bfloat16)
        return p.to(torch.bfloat16)

    return nn.tree_map(one, master)
