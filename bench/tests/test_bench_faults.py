"""The check catches a broken timed path: each cell, at a size the CPU runs,
driven through the whole run but the look for a card, comes out correct as
it is and not correct with each fault it can have planted underneath.  The
limits are the cells' own."""
import time

import pytest
import torch

from bench.harness import driver
from small import DECODE, PREFILL, TRAIN, small_cell

CPU = torch.device("cpu")


def run(name):
    return driver.run_cell(small_cell(name), 2**31 + 11, 0.5, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", [TRAIN, PREFILL, DECODE])
def test_sound_path_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]


def test_step_returning_its_state_unchanged(monkeypatch):
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    def make(cfg, **kw):
        def step(params, state, batch):
            with torch.no_grad():
                loss, _ = M.loss_fn(cfg, params, batch)
            return params, state, {"loss": loss}
        return step

    monkeypatch.setattr(steps, "make_train_step", make)
    assert not run(TRAIN)["correct"]


def test_half_the_batch_left_out_of_training(monkeypatch):
    from repro_torch.launch import steps

    real = steps.make_train_step

    def make(cfg, **kw):
        step = real(cfg, **kw)
        return lambda p, s, b: step(p, s, {k: v[: v.shape[0] // 2] for k, v in b.items()})

    monkeypatch.setattr(steps, "make_train_step", make)
    assert not run(TRAIN)["correct"]


@pytest.mark.parametrize("name", [PREFILL, DECODE])
def test_half_the_batch_left_out_of_serving(monkeypatch, name):
    """The prefill serves the first half of the rows and hands its results to
    the other half too."""
    from repro_torch.launch import steps
    from repro_torch.models import nn

    real = steps.make_prefill_step

    def make(cfg):
        prefill = real(cfg)

        def half(params, batch):
            h = batch["tokens"].shape[0] // 2
            logits, cache = prefill(params, {"tokens": batch["tokens"][:h]})
            return (torch.cat([logits, logits]),
                    nn.tree_map(lambda x: torch.cat([x, x], dim=1), cache))
        return half

    monkeypatch.setattr(steps, "make_prefill_step", make)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", [PREFILL, DECODE])
def test_token_altered_where_it_is_produced(monkeypatch, name):
    from repro_torch.launch import steps

    real = steps.make_decode_step

    def make(cfg):
        decode = real(cfg)

        def altered(params, cache, token, pos):
            nxt, logits, cache = decode(params, cache, token, pos)
            return (nxt + 1) % cfg.vocab_size, logits, cache
        return altered

    monkeypatch.setattr(steps, "make_decode_step", make)
    assert not run(name)["correct"]
