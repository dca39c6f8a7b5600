"""The SSM training path of the port against the JAX package on the CPU: the
chunked scan (``run_chunked_scan``, ``intra_chunk_scan``), Mamba1's training
forward, ``loss_fn`` with its grads on reduced falcon-mamba, and DaeMon
training steps.

``SCAN_CHUNK`` is set to 16 on both modules, so a 64-step sequence spans 4
chunks and the boundary state crosses 3 of them.  Tolerances:
  * SCAN_REL 2^-20 of the largest |value| for the f32 scan: the port's
    Hillis-Steele doubling and ``lax.associative_scan``'s tree multiply and
    add the same terms in other orders, a few f32 ulps (2^-24 each) of the
    largest term over 16-step chunks;
  * BF16_REL, four bf16 ulps of the largest |value|, for a bf16 block
    output (``tests/test_torch_mamba.py``'s);
  * LOSS_RTOL 1e-3 and GRAD_RTOL 3e-2, ``tests/test_torch_train.py``'s.
Run with ``-s`` to print the measured distances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.configs import get_config as jax_get_config
from repro.core import movement as jax_mv
from repro.launch import steps as jax_steps
from repro.models import mamba as jmamba
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.configs import get_config
from repro_torch.convert import daemon_state_from_numpy, params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.launch import steps
from repro_torch.models import mamba
from repro_torch.models import model as M
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

ARCH = "falcon-mamba-7b"
CHUNK = 16
SCAN_REL = 2.0 ** -20
BF16_REL = 2.0 ** -6
LOSS_RTOL = 1e-3
GRAD_RTOL = 3e-2
BATCH, SEQ = 2, 64


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(mamba, "SCAN_CHUNK", CHUNK)
    monkeypatch.setattr(jmamba, "SCAN_CHUNK", CHUNK)


@pytest.fixture(scope="module")
def falcon():
    """Reduced falcon-mamba: the JAX bf16 working copy and the port's load of it."""
    cfg_j, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    params_j = jax_mv.working_copy(jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0)),
                                   jax_mv.DAEMON_DEFAULT)
    return cfg_j, cfg, params_j, params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(ours, theirs, rel, what):
    a, b = _f32(ours), _f32(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    print(f"{what}: max |diff| {err:.3g} at max |value| {scale:.3g} ({err / scale:.3g} of it)")
    assert err <= rel * scale, what


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _rel_l2(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    labels[0, :5] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": labels.astype(np.int32)}


# --------------------------------------------------------------------------
# the chunked scan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [64, 50])  # 4 chunks of 16; ragged: one chunk of 50
def test_chunked_scan_matches_jax(seq, small_chunks):
    """A body that runs ``intra_chunk_scan`` on decays in (0.5, 1) and
    normal inputs and reads y = Σ_n h, under ``run_chunked_scan`` from a
    nonzero state: y and h_last against JAX's."""
    rng = np.random.default_rng(seq)
    da = rng.uniform(0.5, 1.0, (BATCH, seq, 8, 4)).astype(np.float32)
    dbx = rng.normal(size=(BATCH, seq, 8, 4)).astype(np.float32)
    h0 = rng.normal(size=(BATCH, 8, 4)).astype(np.float32)

    def run(mod, lib, t):
        def body(h_in, inputs):
            a, b = inputs
            h_all, h_out = mod.intra_chunk_scan(a, b, h_in)
            return h_out, h_all.sum(-1)

        return mod.run_chunked_scan((t(da), t(dbx)), t(h0), mod.SCAN_CHUNK, body)

    y_j, h_j = jax.jit(lambda: run(jmamba, jnp, jnp.asarray))()
    y, h = run(mamba, torch, torch.from_numpy)
    _close(y, y_j, SCAN_REL, f"chunked scan y, S={seq}")
    _close(h, h_j, SCAN_REL, f"chunked scan h_last, S={seq}")


def test_intra_chunk_scan_matches_jax():
    """One chunk of 37 steps (not a power of two) with the decays of a real
    Mamba1 state, exp(dt·A): h_all and h_last."""
    rng = np.random.default_rng(0)
    dt = rng.uniform(1e-3, 1e-1, (BATCH, 37, 16, 1)).astype(np.float32)
    da = np.exp(dt * -np.arange(1, 9, dtype=np.float32)).astype(np.float32)
    dbx = rng.normal(size=da.shape).astype(np.float32)
    h0 = rng.normal(size=(BATCH, 16, 8)).astype(np.float32)
    h_all_j, h_last_j = jax.jit(jmamba.intra_chunk_scan)(da, dbx, h0)
    h_all, h_last = mamba.intra_chunk_scan(*(torch.from_numpy(a) for a in (da, dbx, h0)))
    _close(h_all, h_all_j, SCAN_REL, "intra_chunk_scan h_all")
    _close(h_last, h_last_j, SCAN_REL, "intra_chunk_scan h_last")


# --------------------------------------------------------------------------
# Mamba1's training forward, loss and grads
# --------------------------------------------------------------------------


def test_mamba1_training_forward_matches_jax(falcon, small_chunks):
    cfg_j, cfg, params_j, params = falcon
    lj = jax.tree.map(lambda a: a[0], params_j["blocks"])
    lt = {k: v[0] for k, v in params["blocks"].items()}
    x = np.random.default_rng(5).normal(size=(BATCH, SEQ, cfg.d_model)) * 0.1
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    out_j, cache_j = jax.jit(lambda p, x: jmamba.mamba1_forward(cfg_j, p, x, make_cache=True))(
        lj, xj)
    out, cache = mamba.mamba1_forward(cfg, lt, xt, make_cache=True, training=True)
    assert out.dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    _close(out, out_j, BF16_REL, "mamba1_forward(training=True) output")
    _close(cache["state"], cache_j["state"], BF16_REL, "mamba1_forward(training=True) state")


def test_loss_and_grads_match_jax(falcon, small_chunks):
    cfg_j, cfg, params_j, params = falcon
    batch = _batch(cfg)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    ))(params_j)
    grads, metrics = steps._value_and_grad(cfg, params, {k: torch.as_tensor(v)
                                                         for k, v in batch.items()})
    rel = abs(float(metrics["loss"]) - float(loss_j)) / abs(float(loss_j))
    print(f"falcon: loss {float(loss_j):.5f}, relative diff {rel:.3g} (limit {LOSS_RTOL})")
    assert rel <= LOSS_RTOL
    assert float(metrics["tokens"]) == float(metrics_j["tokens"]) == BATCH * SEQ - 5
    ours, theirs = dict(_flat(grads)), dict(_flat(grads_j))
    assert ours.keys() == theirs.keys()
    worst = max((_rel_l2(ours[p], g), p) for p, g in theirs.items())
    for path, g_j in theirs.items():
        assert ours[path].dtype == torch.bfloat16 and tuple(ours[path].shape) == g_j.shape
        assert _rel_l2(ours[path], g_j) <= GRAD_RTOL, path
    print(f"falcon: worst grad relative L2 {worst[0]:.3g} at {worst[1]} (limit {GRAD_RTOL})")


def test_training_never_reaches_selective_scan(falcon, monkeypatch, small_chunks):
    """A training forward and backward runs the chunked scan, never the
    forward-only kernel's wrapper; prefill does reach it."""
    _, cfg, _, params = falcon
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}

    def refuse(*args, **kwargs):
        raise AssertionError("training called selective_scan")

    monkeypatch.setattr(mamba, "selective_scan", refuse)
    grads, metrics = steps._value_and_grad(cfg, params, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(g).all()) for g in nn.tree_leaves(grads))
    with pytest.raises(AssertionError, match="selective_scan"):
        steps.make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})


def test_remat_changes_no_grad_bit(falcon, small_chunks):
    _, cfg, _, params = falcon
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    out = {remat: steps._value_and_grad(dataclasses.replace(cfg, remat=remat), params, batch)
           for remat in ("nothing", "dots", "full")}
    grads, loss = nn.tree_leaves(out["nothing"][0]), out["nothing"][1]["loss"]
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][1]["loss"], loss), remat
        for a, b in zip(nn.tree_leaves(out[remat][0]), grads):
            assert torch.equal(a, b), remat


# the reduced model, and one as wide as 1024 over a vocabulary of 4096 on one
# layer: there both packages memorise the first batch (the full-width model
# scores it 0.063 after 5 steps on the card), here it drops by ~3 nats
WIDTHS = {"reduced": {}, "wide": {"num_layers": 1, "d_model": 1024, "vocab_size": 4096,
                                  "ssm_state": 16, "dt_rank": 64}}


@pytest.mark.parametrize("width", list(WIDTHS))
def test_daemon_steps_match_jax(width, small_chunks):
    """5 DAEMON_AGGRESSIVE steps (int8 fold with error feedback, int8 working
    copy of the page-class weights) from the same converted state and
    batches: each loss within LOSS_RTOL, the master within 2·Σlr as in
    ``tests/test_torch_train.py``, a live residual, and the first batch's
    loss taken again under the final working copy within LOSS_RTOL of
    JAX's and below where it started.  Step 0's lr is 0, so the first
    batch's gradient enters every later update only through AdamW's first
    moment, as in ``chip_smoke.py``'s training phases."""
    cfg_j = dataclasses.replace(jax_get_config(ARCH).reduced(), **WIDTHS[width])
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **WIDTHS[width])
    level = "DAEMON_AGGRESSIVE"
    n_steps = 5
    master_j = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0))
    state_j = jax_mv.init_state(master_j)
    params_j = jax_mv.working_copy(master_j, getattr(jax_mv, level))
    state = daemon_state_from_numpy(jax.tree.map(np.asarray, state_j), "cpu")
    params = mv.working_copy(state.master, getattr(mv, level))
    step_j = jax.jit(jax_steps.make_train_step(
        cfg_j, total_steps=n_steps - 1, movement="daemon", movement_cfg=getattr(jax_mv, level)))
    step = steps.make_train_step(cfg, total_steps=n_steps - 1, movement="daemon",
                                 movement_cfg=getattr(mv, level))
    batches = [_batch(cfg, seed=10 + i) for i in range(n_steps)]
    lr_sum, losses = 0.0, []
    for i, batch in enumerate(batches):
        params_j, state_j, m_j = step_j(params_j, state_j, jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, {k: torch.as_tensor(v) for k, v in batch.items()})
        losses.append(float(m_j["loss"]))
        rel = abs(float(m["loss"]) - losses[-1]) / losses[-1]
        print(f"falcon {width} step {i}: loss {losses[-1]:.5f} rel diff {rel:.3g}")
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
    print(f"falcon {width}: master max |diff| {worst:.3g} (limit 2·Σlr = {2 * lr_sum:.3g}); "
          f"{far / n:.3%} beyond 0.1·Σlr")
    assert worst <= 2 * lr_sum and far / n < 1e-2
    assert sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual)) > 0
    again_j = float(jax.jit(lambda p, b: JM.loss_fn(cfg_j, p, b)[0])(
        params_j, jax.tree.map(jnp.asarray, batches[0])))
    with torch.no_grad():
        again = float(M.loss_fn(cfg, params, {k: torch.as_tensor(v)
                                              for k, v in batches[0].items()})[0])
    rel = abs(again - again_j) / again_j
    print(f"falcon {width}: first batch {losses[0]:.5f} before, JAX {again_j:.5f} and port "
          f"{again:.5f} after {n_steps} steps (rel diff {rel:.3g}); new batches "
          f"{min(losses[1:]):.5f}-{max(losses[1:]):.5f}")
    assert rel <= LOSS_RTOL and again < losses[0]
