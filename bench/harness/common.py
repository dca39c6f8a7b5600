"""Helpers the traffic kinds share."""
from __future__ import annotations

import gc
import math

import numpy as np
import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def movement_config(stated: dict):
    """The port's named movement configuration, held to the fields the
    traffic file states for it."""
    from repro_torch.core import movement as mv

    out = getattr(mv, stated["name"])
    for key, want in stated.items():
        if key != "name" and getattr(out, key) != want:
            raise RuntimeError(f"the port's {stated['name']}.{key} is {getattr(out, key)!r}, "
                               f"the traffic file states {want!r}")
    return out


def nearest_rank(values, q: float) -> float:
    """The nearest-rank ``q`` quantile: the smallest value with at least a
    share ``q`` of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def sample(n: int, k: int, seed: int, must=()) -> list:
    """``k`` of range(n) without replacement, drawn from ``seed``, holding at
    least one of ``must`` when it is not empty."""
    rng = np.random.default_rng(seed)
    pick = [int(i) for i in rng.choice(n, size=min(k, n), replace=False)]
    if must and not set(pick) & set(must):
        pick[-1] = int(rng.choice(list(must)))
    return sorted(pick)


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each token's reference logit lies below the reference's
    best at its position: ref_logits (..., V), tokens (...)."""
    picked = torch.gather(ref_logits, -1, tokens.long().to(ref_logits.device)[..., None])[..., 0]
    return ref_logits.amax(-1) - picked


def leaf_gap(side: dict, ref: dict, counted, leaf) -> float:
    """|side's norm - reference's norm| of ``leaf`` over the larger of the
    reference's norm of that leaf and of the median counted leaf."""
    med = float(np.median([ref[k] for k in counted]))
    return abs(side[leaf] - ref[leaf]) / max(ref[leaf], med)
