"""The port's MoE family in training against the JAX package on the CPU:
reduced deepseek-v2-lite and dbrx's ``loss_fn`` (loss, aux and grads), 3
DAEMON_AGGRESSIVE steps at a width where the 4-D expert stacks are page
class, and the training driver.  Helpers, tolerances and the routing of the
port as JAX routes come from ``tests/test_torch_moe.py``, whose docstring
states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from test_torch_moe import (BATCH, DBRX, DEEPSEEK, GRAD_RTOL, LOSS_RTOL, SEQ, WIDE, _configs,
                            _f32, _flat, _np, _rel_l2, _Routes, model)  # noqa: F401 (fixture)

from repro.core import movement as jax_mv
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.convert import daemon_state_from_numpy
from repro_torch.core import movement as mv
from repro_torch.core.movement import daemon_step
from repro_torch.launch import steps
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    labels[1, -3:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": labels.astype(np.int32)}


def test_loss_and_grads_match_jax(model, monkeypatch):
    """``loss_fn``: the loss (cross-entropy, z-loss and 0.01 x the aux loss
    summed over the MoE layers), the aux itself, and every grad leaf, routed
    as JAX routes (``_Routes``; a rematerialised layer routes again in
    backward)."""
    arch, cfg_j, cfg, params_j, params = model
    routes = _Routes(monkeypatch)
    batch = _batch(cfg)
    (loss_j, metrics_j), grads_j = routes.jax_call(jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    )), params_j)
    grads, metrics = steps._value_and_grad(cfg, params, {k: torch.as_tensor(v)
                                                         for k, v in batch.items()})
    routes.report(f"{arch} loss_fn and its grads")
    rel = abs(float(metrics["loss"]) - float(loss_j)) / abs(float(loss_j))
    aux_rel = abs(float(metrics["aux"]) - float(metrics_j["aux"])) / float(metrics_j["aux"])
    print(f"{arch}: loss {float(loss_j):.5f} relative diff {rel:.3g}, aux "
          f"{float(metrics_j['aux']):.5f} relative diff {aux_rel:.3g} (limit {LOSS_RTOL})")
    assert rel <= LOSS_RTOL and aux_rel <= LOSS_RTOL
    assert float(metrics_j["aux"]) > 0
    assert float(metrics["tokens"]) == float(metrics_j["tokens"]) == BATCH * SEQ - 3
    ours, theirs = dict(_flat(grads)), dict(_flat(grads_j))
    assert ours.keys() == theirs.keys()
    worst = max((_rel_l2(ours[p], g), p) for p, g in theirs.items())
    for path, g_j in theirs.items():
        assert ours[path].dtype == torch.bfloat16 and tuple(ours[path].shape) == g_j.shape
        assert _rel_l2(ours[path], g_j) <= GRAD_RTOL, path
    print(f"{arch}: worst grad relative L2 {worst[0]:.3g} at {worst[1]} (limit {GRAD_RTOL})")


@pytest.mark.parametrize("arch", [DEEPSEEK, DBRX])
def test_daemon_steps_match_jax(arch, monkeypatch):
    """3 DAEMON_AGGRESSIVE steps (the int8 fold with error feedback, the int8
    working copy of the page-class weights, among them the 4-D expert
    stacks) from the same converted state and batches, routed as JAX routes
    (``_Routes``): each loss within LOSS_RTOL, the master within 2·Σlr as in
    ``tests/test_torch_train.py``, and a live residual."""
    routes = _Routes(monkeypatch)
    cfg_j, cfg = _configs(arch, **WIDE)
    level = "DAEMON_AGGRESSIVE"
    n_steps = 3
    master_j = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0))
    paged = [p for p, w in _flat(master_j) if daemon_step.is_page_class(w.shape)]
    assert any(w.ndim == 4 for p, w in _flat(master_j) if p in paged)
    state_j = jax_mv.init_state(master_j)
    params_j = jax_mv.working_copy(master_j, getattr(jax_mv, level))
    state = daemon_state_from_numpy(_np(state_j), "cpu")
    params = mv.working_copy(state.master, getattr(mv, level))
    step_j = jax.jit(jax_steps.make_train_step(
        cfg_j, total_steps=n_steps, movement="daemon", movement_cfg=getattr(jax_mv, level)))
    step = steps.make_train_step(cfg, total_steps=n_steps, movement="daemon",
                                 movement_cfg=getattr(mv, level))
    lr_sum = 0.0
    for i in range(n_steps):
        batch = _batch(cfg, seed=10 + i)
        params_j, state_j, m_j = routes.jax_call(step_j, params_j, state_j,
                                                 jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, {k: torch.as_tensor(v) for k, v in batch.items()})
        routes.report(f"{arch} {level} steps 0-{i}")
        rel = abs(float(m["loss"]) - float(m_j["loss"])) / float(m_j["loss"])
        print(f"{arch} {level} step {i}: loss {float(m_j['loss']):.5f} rel diff {rel:.3g}")
        assert rel <= LOSS_RTOL
        np.testing.assert_allclose(float(m["lr"]), float(m_j["lr"]), rtol=1e-6)
        lr_sum += float(m_j["lr"])
    assert int(state.adam.step) == int(state_j.adam.step) == n_steps
    ours, theirs = dict(_flat(state.master)), dict(_flat(state_j.master))
    assert ours.keys() == theirs.keys()
    worst, far = 0.0, 0
    for path, w_j in theirs.items():
        d = np.abs(_f32(ours[path]) - _f32(w_j))
        worst = max(worst, float(d.max()))
        far += int((d > 0.1 * lr_sum).sum())
    n = sum(np.asarray(w).size for w in theirs.values())
    print(f"{arch} {level}: master max |diff| {worst:.3g} (limit 2·Σlr = {2 * lr_sum:.3g}); "
          f"{far / n:.3%} beyond 0.1·Σlr; {len(paged)} page-class leaves")
    assert worst <= 2 * lr_sum and far / n < 1e-2
    assert sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual)) > 0


def test_train_driver_runs_the_moe_family():
    """``train(..., movement="daemon")`` on reduced deepseek, on the CPU."""
    from repro_torch.launch.train import train

    _, state, losses = train(DEEPSEEK, reduced=True, steps=3, global_batch=2, seq_len=32,
                             movement="daemon", log_every=10, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert isinstance(state, mv.DaemonState) and int(state.adam.step) == 3


