"""The two serving steps (port of the prefill/decode half of
``repro.launch.steps``); the training step comes with the training slice."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def decode_step(params, cache, token, pos: int):
        logits, cache = M.decode_step(cfg, params, cache, token, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step
