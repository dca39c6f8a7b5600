"""Weights and inputs made from the seed, on the device, by the benchmark.

Every stream of random numbers a run draws (weights, training batches,
prompts, the turns' first tokens, the check's sample) has a generator of its
own, seeded from ``--seed`` and the stream's name, so that the reference can
draw the same tensors again after the window without replaying the others.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from bench.harness.config import is_norm, param_shapes


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of run ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def iter_weights(cfg: dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, float32 weight) in path order: norm scales 1, every other
    tensor normal with std 1/sqrt(fan_in) (fan_in: the second-to-last dim),
    drawn leaf after leaf from one generator on ``device``."""
    gen = generator(seed, "weights", device)
    for path, shape in param_shapes(cfg).items():
        if is_norm(path):
            yield path, torch.ones(shape, dtype=torch.float32, device=device)
        else:
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            yield path, x.mul_(1.0 / math.sqrt(shape[-2]))


def draw_weights(cfg: dict, seed: int, device,
                 then: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """path -> weight of :func:`iter_weights`; ``then`` maps each leaf as it
    is drawn (the float32 leaf is released after it)."""
    return {path: x if then is None else then(x) for path, x in iter_weights(cfg, seed, device)}


def token_ids(gen: torch.Generator, vocab: int, shape, device) -> torch.Tensor:
    return torch.randint(0, vocab, tuple(shape), generator=gen, dtype=torch.int32,
                         device=device)
