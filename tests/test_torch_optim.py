"""The port's optimizer (``repro_torch.optim``) against the JAX package's on
the CPU, on the same inputs.

Tolerances: both sides compute in f32 in the same order, so the schedules and
the AdamW step agree to an f32 rounding or two (XLA fuses some multiplies
into adds, rewrites (m / bc1) / d as m / (bc1 * d), and sums a norm in
another order): rtol 1e-6, about 8 f32 ulps.  An AdamW output that cancels
to near zero (p - lr * delta with p ~ lr * delta) carries the rounding of its
terms, not of itself, so those are held to 1e-6 of the leaf's largest value.
Run with ``-s`` to print the measured distances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.optim import adamw as jax_adamw
from repro.optim import schedule as jax_schedule

from repro_torch.convert import adamw_state_from_numpy, params_from_numpy
from repro_torch.models import nn
from repro_torch.optim import adamw, schedule

jax.config.update("jax_platform_name", "cpu")

RTOL = 1e-6
STEPS = np.arange(0, 1001)

SCHEDULES = [
    ("cosine", dict(peak_lr=3e-4, total_steps=1000, warmup_steps=100)),
    ("cosine", dict(peak_lr=1.0, total_steps=8, warmup_steps=1)),
    ("wsd", dict(peak_lr=1.0, total_steps=1000, warmup_steps=100)),
    ("wsd", dict(peak_lr=2e-3, total_steps=37, warmup_steps=3)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedule_matches_jax(name, kw):
    ours = schedule.make(name, **kw)(torch.as_tensor(STEPS)).numpy()
    theirs = np.asarray(jax_schedule.make(name, **kw)(jnp.asarray(STEPS)))
    assert ours.dtype == theirs.dtype == np.float32
    rel = np.abs(ours - theirs).max() / np.abs(theirs).max()
    print(f"{name} {kw}: max relative diff {rel:.3g}")
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=0)
    # one step at a time, as the train step asks (a 0-dim int32 step)
    for s in (0, 1, 5, kw["total_steps"] - 1):
        one = schedule.make(name, **kw)(torch.tensor(s, dtype=torch.int32))
        np.testing.assert_allclose(one.numpy(), theirs[s], rtol=RTOL, atol=0)


def _tree(rng, dtype=np.float32):
    return {
        "a": rng.normal(size=(3, 128)).astype(dtype),
        "b": {"w": (rng.normal(size=(2, 4, 8)) * 5).astype(dtype),
              "s": rng.normal(size=(8,)).astype(dtype)},
    }


def _pairs(ours, theirs):
    return zip(nn.tree_leaves(ours), jax.tree.leaves(theirs))


@pytest.mark.parametrize("scale", [0.01, 10.0])  # under and over max_norm = 1
def test_global_norm_and_clip_match_jax(scale):
    rng = np.random.default_rng(0)
    g = nn.tree_map(lambda a: a * scale, _tree(rng))
    norm = adamw.global_norm(params_from_numpy(g, "cpu"))
    norm_j = jax_adamw.global_norm(g)
    np.testing.assert_allclose(norm.numpy(), np.asarray(norm_j), rtol=RTOL)
    clipped, n = adamw.clip_by_global_norm(params_from_numpy(g, "cpu"), 1.0)
    clipped_j, n_j = jax_adamw.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(n.numpy(), np.asarray(n_j), rtol=RTOL)
    for a, b in _pairs(clipped, clipped_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=0)


@pytest.mark.parametrize("grad_scale", [0.05, 3.0])
def test_adamw_update_matches_jax(grad_scale):
    """Three AdamW steps from the same params and state, fed the same grads
    (clipped on the second scale): params, m, v, step, grad_norm equal to
    rtol 1e-6."""
    rng = np.random.default_rng(1)
    params_j = jax.tree.map(jnp.asarray, _tree(rng))
    state_j = jax_adamw.init(params_j)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    state = adamw_state_from_numpy(jax.tree.map(np.asarray, state_j), "cpu")
    worst = 0.0
    for i, lr in enumerate([0.0, 1e-2, 3e-3]):
        g = nn.tree_map(lambda a: a * grad_scale, _tree(np.random.default_rng(10 + i)))
        params_j, state_j, om_j = jax_adamw.update(g, state_j, params_j, jnp.float32(lr))
        params, state, om = adamw.update(params_from_numpy(g, "cpu"), state, params,
                                         torch.tensor(lr, dtype=torch.float32))
        assert int(state.step) == int(state_j.step) == i + 1
        np.testing.assert_allclose(om["grad_norm"].numpy(), np.asarray(om_j["grad_norm"]),
                                   rtol=RTOL)
        for ours, theirs in ((params, params_j), (state.m, state_j.m), (state.v, state_j.v)):
            for a, b in _pairs(ours, theirs):
                b = np.asarray(b)
                worst = max(worst, float(np.abs(a.numpy() - b).max() / np.abs(b).max()))
                np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=RTOL * np.abs(b).max())
    print(f"grad scale {grad_scale}: max diff / leaf's max |value| {worst:.3g}")


def test_adamw_update_writes_in_place():
    params = {"w": torch.ones(4)}
    state = adamw.init(params)
    w, m = params["w"], state.m["w"]
    new_params, new_state, _ = adamw.update({"w": torch.ones(4)}, state, params,
                                            torch.tensor(0.1))
    assert new_params["w"] is w and new_state.m["w"] is m
    assert float(w[0]) < 1.0 and float(m[0]) > 0.0


def test_adamw_reduces_loss_quadratic():
    """tests/test_substrates.py's quadratic, mirrored."""
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(grads, state, params, lr=torch.tensor(0.05),
                                        weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.2
