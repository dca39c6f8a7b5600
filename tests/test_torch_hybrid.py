"""The port's hybrid family (zamba2: Mamba2 blocks and one shared attention
block with LoRA) against the JAX package on the CPU: the Mamba2 block in
both bodies, the shared block at each invocation, prefill and greedy decode,
``serve``, the loss and its grads, and 3 DaeMon training steps.

Reduced zamba2 is cut to 5 layers, so the shared block runs 3 times (at
layers 0, 2 and 4) and the last group is ragged.  The LoRA ``b`` stacks are
drawn from a seed instead of their zero init, so every adapter moves the
values.  Tolerances: ``BF16_REL`` (four bf16 ulps of the largest |value|) for
one block's output and state; ``MODEL_REL`` 2^-4 of the largest |value| for
the caches of a whole prefill, where the residual stream grows to |x| ~ 10
over 3 shared blocks and 5 Mamba2 layers and the blocks' ulps compound (2-3 %
measured); ``LOGIT_TOL`` 8e-2 for logits, ``LOSS_RTOL`` 1e-3 and
``GRAD_RTOL`` 3e-2 for training, the dense and SSM tests' limits.
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
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import hybrid as jhybrid
from repro.models import mamba as jmamba
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.configs import get_config
from repro_torch.convert import daemon_state_from_numpy, params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.launch import steps
from repro_torch.launch.serve import _grow_cache, serve
from repro_torch.models import hybrid, mamba
from repro_torch.models import model as M
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

ARCH = "zamba2-1.2b"
LAYERS = 5
BF16_REL = 2.0 ** -6
LOGIT_TOL = 8e-2
LOSS_RTOL = 1e-3
MODEL_REL = 2.0 ** -4
GRAD_RTOL = 3e-2
BATCH, SEQ, PROMPT, GEN = 2, 64, 32, 6


def _configs():
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), num_layers=LAYERS),
            dataclasses.replace(get_config(ARCH).reduced(), num_layers=LAYERS))


def _master_j(cfg_j, seed=0):
    """JAX-initialised f32 master with the LoRA b stacks drawn from a seed."""
    master = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    shared = dict(master["trunk"]["shared"])
    for name in ("q", "k", "v"):
        b = shared[f"lora_{name}_b"]
        shared[f"lora_{name}_b"] = jnp.asarray(rng.normal(size=b.shape) * 0.1, jnp.float32)
    return {**master, "trunk": {**master["trunk"], "shared": shared}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def zamba():
    """Reduced zamba2 (5 layers): the JAX bf16 working copy and the port's load of it."""
    cfg_j, cfg = _configs()
    params_j = jax_mv.working_copy(_master_j(cfg_j), jax_mv.DAEMON_DEFAULT)
    return cfg_j, cfg, params_j, params_from_numpy(_np(params_j), "cpu")


@pytest.fixture
def small_chunks(monkeypatch):
    """SCAN_CHUNK 16 on both sides: the SSD body runs 16-step chunks, the
    elementwise body 4-step ones, so the state crosses chunk boundaries."""
    monkeypatch.setattr(mamba, "SCAN_CHUNK", 16)
    monkeypatch.setattr(jmamba, "SCAN_CHUNK", 16)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(ours, theirs, what, rel=BF16_REL):
    a, b = _f32(ours), _f32(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    print(f"{what}: max |diff| {err:.3g} at max |value| {scale:.3g}")
    assert err <= rel * scale, what


def _rel_l2(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16(shape, seed, scale=1.0):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale, jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


def _mamba_layer(params_j, params, i=0):
    return (jax.tree.map(lambda a: a[i], params_j["trunk"]["mamba"]),
            {k: v[i] for k, v in params["trunk"]["mamba"].items()})


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    labels[1, -3:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": labels.astype(np.int32)}


def _grow_attn(cache_j, total_len):
    """JAX's cache with only the attention buffers padded to ``total_len``:
    JAX's own ``_grow_cache`` pads the SSM leaves too, and its decode fails."""
    pad = lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, total_len - x.shape[2]), (0, 0), (0, 0)])
    return {**cache_j, "attn": jax.tree.map(pad, cache_j["attn"])}


# --------------------------------------------------------------------------
# the Mamba2 block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["ssd", "scan"])
def test_mamba2_forward_matches_jax(zamba, algo, small_chunks):
    cfg_j, cfg, params_j, params = zamba
    cfg_j, cfg = (dataclasses.replace(c, ssm_algo=algo) for c in (cfg_j, cfg))
    lj, lt = _mamba_layer(params_j, params)
    xj, xt = _bf16((BATCH, SEQ, cfg.d_model), 5, scale=0.1)
    out_j, cache_j = jax.jit(lambda p, x: jmamba.mamba2_forward(cfg_j, p, x, make_cache=True))(
        lj, xj)
    out, cache = mamba.mamba2_forward(cfg, lt, xt, make_cache=True)
    assert out.dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    _close(out, out_j, f"mamba2_forward ({algo}) output")
    _close(cache["state"], cache_j["state"], f"mamba2_forward ({algo}) state")
    np.testing.assert_array_equal(_f32(cache["conv"]), _f32(cache_j["conv"]))


def test_mamba2_decode_matches_jax(zamba):
    cfg_j, cfg, params_j, params = zamba
    lj, lt = _mamba_layer(params_j, params, 3)
    xj, xt = _bf16((BATCH, 1, cfg.d_model), 6, scale=0.1)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    tj, tt = _bf16((BATCH, cfg.ssm_conv - 1, conv_dim), 7)
    state = np.random.default_rng(8).normal(
        size=(BATCH, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32) * 0.01
    out_j, new_j = jax.jit(lambda p, x, c: jmamba.mamba2_decode(cfg_j, p, x, c))(
        lj, xj, {"state": jnp.asarray(state), "conv": tj})
    out, new = mamba.mamba2_decode(cfg, lt, xt, {"state": torch.from_numpy(state), "conv": tt})
    _close(out, out_j, "mamba2_decode output")
    _close(new["state"], new_j["state"], "mamba2_decode state")
    np.testing.assert_array_equal(_f32(new["conv"]), _f32(new_j["conv"]))


def test_ssd_gradient_stays_finite_where_jax_overflows():
    """With decays large enough that exp of a masked (j > i) log-decay
    overflows, JAX's SSD body (``mamba.py:244-246``) gives NaN gradients
    (0·inf); the port masks before exp: the same output, finite gradients."""
    cfg_j, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    p_j = jax.tree.map(lambda a: a[0], _master_j(cfg_j)["trunk"]["mamba"])
    p_j = dict(p_j, dt_b=jnp.full_like(p_j["dt_b"], 1.0))  # dt ~ 1.3 a step, A = -(1..8):
    # over a 128-step chunk the log-decays above the diagonal pass 88, where exp overflows
    xj, xt = _bf16((1, 128, cfg.d_model), 9)
    loss_j = lambda p: jnp.sum(jmamba.mamba2_forward(cfg_j, p, xj)[0].astype(jnp.float32) ** 2)
    grads_j = jax.jit(jax.grad(loss_j))(p_j)
    nan_j = sorted(k for k, g in grads_j.items() if not bool(jnp.isfinite(g).all()))
    print(f"JAX's SSD gradient is not finite at: {nan_j}")
    assert nan_j

    p = {k: v.requires_grad_() for k, v in params_from_numpy(_np(p_j), "cpu").items()}
    out, _ = mamba.mamba2_forward(cfg, p, xt)
    torch.sum(out.to(torch.float32) ** 2).backward()
    assert all(bool(torch.isfinite(v.grad).all()) for v in p.values())
    _close(out, jax.jit(lambda p: jmamba.mamba2_forward(cfg_j, p, xj)[0])(p_j),
           "mamba2_forward with overflowing decays")


# --------------------------------------------------------------------------
# the shared attention block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("inv", [0, 1, 2])
def test_shared_block_matches_jax(zamba, inv):
    """Prefill over 24 positions, then one decode step at position 24 into a
    cache of 32, with invocation ``inv``'s LoRA adapters."""
    cfg_j, cfg, params_j, params = zamba
    pj, pt = params_j["trunk"]["shared"], params["trunk"]["shared"]
    s, total = 24, 32
    xj, xt = _bf16((BATCH, s, cfg.d_model), 10 + inv)
    ej, et = _bf16((BATCH, s, cfg.d_model), 20 + inv)
    out_j, c_j = jax.jit(lambda p, x, e: jhybrid.apply_shared_block(
        cfg_j, p, x, e, inv, jnp.arange(s), make_cache=True))(pj, xj, ej)
    out, c = hybrid.apply_shared_block(cfg, pt, xt, et, inv, torch.arange(s), make_cache=True)
    _close(out, out_j, f"shared block {inv} prefill output")
    for key in ("k", "v"):
        _close(c[key], c_j[key], f"shared block {inv} prefill {key}")

    xj1, xt1 = _bf16((BATCH, 1, cfg.d_model), 30 + inv)
    ej1, et1 = _bf16((BATCH, 1, cfg.d_model), 40 + inv)
    grown_j = {k: jnp.pad(v, [(0, 0), (0, total - s), (0, 0), (0, 0)]) for k, v in c_j.items()}
    grown = {k: params_from_numpy(np.asarray(v), "cpu") for k, v in grown_j.items()}
    dec_j, new_j = jax.jit(lambda p, x, e, cc: jhybrid.apply_shared_block_decode(
        cfg_j, p, x, e, inv, cc, jnp.asarray(s)))(pj, xj1, ej1, grown_j)
    dec, new = hybrid.apply_shared_block_decode(cfg, pt, xt1, et1, inv, grown, s)
    _close(dec, dec_j, f"shared block {inv} decode output")
    for key in ("k", "v"):
        assert new[key] is grown[key]  # written in place
        _close(new[key], new_j[key], f"shared block {inv} decode {key}")


# --------------------------------------------------------------------------
# the model: prefill, decode, serve
# --------------------------------------------------------------------------


def test_prefill_and_decode_match_jax(zamba, monkeypatch, small_chunks):
    """JAX's prefill and decode_step against the port's, on JAX's cache with
    only ``attn`` grown; prefill calls K3's wrapper once per invocation."""
    cfg_j, cfg, params_j, params = zamba
    calls, real = [], hybrid.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(hybrid, "flash_attention", counting)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    logits_j, cache_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(
        params_j, {"tokens": jnp.asarray(prompt, jnp.int32)})
    logits, cache = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompt, dtype=torch.int32)})
    assert len(calls) == hybrid.n_invocations(cfg) == 3
    err = float(np.abs(_f32(logits) - _f32(logits_j)).max())
    print(f"prefill logits max |diff| {err:.3g}")
    assert err <= LOGIT_TOL
    specs = dict(_flat(M.cache_specs(cfg, BATCH, PROMPT)))
    ours, theirs = dict(_flat(cache)), dict(_flat(cache_j))
    assert ours.keys() == theirs.keys() == specs.keys()
    for path, leaf in theirs.items():
        assert tuple(ours[path].shape) == specs[path].shape
        _close(ours[path], leaf, f"prefill cache {'/'.join(path)}", MODEL_REL)

    cache = _grow_cache(cfg, cache, PROMPT + GEN)
    cache_j = _grow_attn(cache_j, PROMPT + GEN)
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    tok_j = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    worst = 0.0
    for i in range(GEN):
        pos = PROMPT + i
        next_j, lj, cache_j = decode_j(params_j, cache_j, tok_j, jnp.asarray(pos, jnp.int32))
        next_tok, lt, cache = decode(params, cache, torch.tensor(np.asarray(tok_j)), pos)
        diff = float(np.abs(_f32(lt) - _f32(lj)).max())
        worst = max(worst, diff)
        assert diff <= LOGIT_TOL, (i, diff)
        top2 = np.sort(_f32(lj), axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
        assert (next_tok.numpy()[clear] == np.asarray(next_j)[clear]).all()
        tok_j = next_j
    assert len(calls) == 3  # decode attends with plain products
    print(f"decode logits max |diff| over {GEN} steps {worst:.3g}")
    for g in range(3):
        _close(cache[f"ssm{g}"]["state"], cache_j[f"ssm{g}"]["state"],
               f"ssm{g} state after {GEN} steps", MODEL_REL)


def test_serve_runs_and_grow_cache_leaves_ssm_alone(zamba):
    """``serve`` runs the hybrid on the CPU; its ``_grow_cache`` grows the
    attention buffers and leaves every ``ssm{g}`` leaf as it was.  JAX's
    ``serve`` fails on the same call (ROADMAP Queue 3): its ``_grow_cache``
    pads the conv tails and states."""
    cfg_j, cfg, params_j, params = zamba
    r = serve(ARCH, reduced=True, batch=2, prompt_len=16, gen_tokens=4, device="cpu")
    assert r["tokens"].shape == (2, 4) and ((r["tokens"] >= 0) & (r["tokens"] < 256)).all()

    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, 16))
    _, cache = steps.make_prefill_step(cfg)(params, {"tokens": torch.as_tensor(prompt)})
    grown = _grow_cache(cfg, cache, 20)
    specs = dict(_flat(M.cache_specs(cfg, BATCH, 20)))
    for path, leaf in _flat(grown):
        assert tuple(leaf.shape) == specs[path].shape, path
        if path[0] != "attn":
            assert leaf is dict(_flat(cache))[path]
    assert grown["attn"]["k"].shape[2] == 20 and cache["attn"]["k"].shape[2] == 16

    with pytest.raises(ValueError) as err:
        jax_serve.serve(ARCH, reduced=True, batch=2, prompt_len=16, gen_tokens=4)
    print(f"JAX's serve on {ARCH}: {type(err.value).__name__}: {err.value}")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def test_loss_and_grads_match_jax(zamba, monkeypatch, small_chunks):
    """``loss_fn`` and its grads; training attends through nn.attention and
    never calls K3's wrapper.  One SSD chunk of 64 steps would make JAX's
    gradient NaN (ROADMAP Queue 3), so the chunks are 16 steps long on both
    sides."""
    cfg_j, cfg, params_j, params = zamba

    def refuse(*args, **kwargs):
        raise AssertionError("training called flash_attention")

    monkeypatch.setattr(hybrid, "flash_attention", refuse)
    batch = _batch(cfg)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    ))(params_j)
    grads, metrics = steps._value_and_grad(cfg, params, {k: torch.as_tensor(v)
                                                         for k, v in batch.items()})
    rel = abs(float(metrics["loss"]) - float(loss_j)) / abs(float(loss_j))
    print(f"zamba2: loss {float(loss_j):.5f}, relative diff {rel:.3g} (limit {LOSS_RTOL})")
    assert rel <= LOSS_RTOL
    assert float(metrics["tokens"]) == float(metrics_j["tokens"]) == BATCH * SEQ - 3
    ours, theirs = dict(_flat(grads)), dict(_flat(grads_j))
    assert ours.keys() == theirs.keys()
    worst = max((_rel_l2(ours[p], g), p) for p, g in theirs.items())
    for path, g_j in theirs.items():
        assert ours[path].dtype == torch.bfloat16 and tuple(ours[path].shape) == g_j.shape
        assert _rel_l2(ours[path], g_j) <= GRAD_RTOL, path
    print(f"zamba2: worst grad relative L2 {worst[0]:.3g} at {worst[1]} (limit {GRAD_RTOL})")


def test_daemon_steps_match_jax(small_chunks):
    """3 DAEMON_AGGRESSIVE steps (int8 fold with error feedback, int8 working
    copy of the page-class weights) from the same converted state and
    batches: each loss within LOSS_RTOL, the master within 2·Σlr as in
    ``tests/test_torch_train.py``, and a live residual.  16-step SSD chunks,
    as in the grads test: in one chunk of 64 JAX's first gradient is NaN."""
    cfg_j, cfg = _configs()
    level = "DAEMON_AGGRESSIVE"
    n_steps = 3
    master_j = _master_j(cfg_j)
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
        params_j, state_j, m_j = step_j(params_j, state_j, jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, {k: torch.as_tensor(v) for k, v in batch.items()})
        rel = abs(float(m["loss"]) - float(m_j["loss"])) / float(m_j["loss"])
        print(f"{level} step {i}: loss {float(m_j['loss']):.5f} rel diff {rel:.3g}")
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
    print(f"{level}: master max |diff| {worst:.3g} (limit 2·Σlr = {2 * lr_sum:.3g}); "
          f"{far / n:.3%} beyond 0.1·Σlr")
    assert worst <= 2 * lr_sum and far / n < 1e-2
    assert sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual)) > 0


def test_param_count_matches_jax_at_full_size():
    cfg = get_config(ARCH)
    assert M.param_count(cfg) == JM.param_count(jax_get_config(ARCH)) == 1_224_872_832
    assert hybrid.n_invocations(cfg) == 7
    assert hybrid._groups(cfg)[-1] == (36, 2)
