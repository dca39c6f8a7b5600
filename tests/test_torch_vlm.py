"""The port's VLM prefix-patch path (internvl2) against the JAX package on
the CPU: ``forward_hidden`` over patches + tokens, prefill and greedy decode
with the patches in the cache, ``serve``'s grown cache, the loss and its
grads, 3 DaeMon steps, and the training driver.

Reduced internvl2: 2 layers, d_model 64, 4 heads of 16 with 2 kv heads, 4
patch tokens, attention chunk 32.  JAX's ``nn.attention`` takes a sequence
the chunk divides, so patches + tokens are 64 long (60 text tokens).
Tolerances: ``BF16_REL`` (four bf16 ulps of the largest |value|) for hidden
states and caches; ``LOGIT_TOL`` 8e-2 for logits, ``LOSS_RTOL`` 1e-3 and
``GRAD_RTOL`` 3e-2 for training, the other families' limits.  Run with
``-s`` to print the distances.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.configs import get_config as jax_get_config
from repro.core import movement as jax_mv
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.configs import get_config
from repro_torch.convert import daemon_state_from_numpy, params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.launch import steps
from repro_torch.launch.serve import _grow_cache, serve
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.models import nn, transformer

jax.config.update("jax_platform_name", "cpu")

ARCH = "internvl2-76b"
BF16_REL = 2.0 ** -6
LOGIT_TOL = 8e-2
LOSS_RTOL = 1e-3
GRAD_RTOL = 3e-2
BATCH, TEXT, GEN = 2, 60, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close(ours, theirs, what, rel=BF16_REL):
    a, b = _f32(ours), _f32(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    print(f"{what}: max |diff| {err:.3g} at max |value| {scale:.3g}")
    assert err <= rel * scale, what


def _rel_l2(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def vlm():
    """Reduced internvl2: the JAX bf16 working copy and the port's load of it."""
    cfg_j, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    master = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0))
    params_j = jax_mv.working_copy(master, jax_mv.DAEMON_DEFAULT)
    return cfg_j, cfg, params_j, params_from_numpy(_np(params_j), "cpu")


def _batch(cfg, seed, text=TEXT, labels=False):
    """Random bf16 patches (the ViT stub's output) and tokens, as JAX arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (BATCH, text)), jnp.int32),
           "patches": jnp.asarray(rng.normal(size=(BATCH, cfg.num_prefix_tokens, cfg.d_model)),
                                  jnp.bfloat16)}
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (BATCH, text))
        lab[1, -3:] = -1
        out["labels"] = jnp.asarray(lab, jnp.int32)
    return out


def _port_batch(batch_j):
    return {k: params_from_numpy(np.asarray(v), "cpu") for k, v in batch_j.items()}


def test_forward_hidden_matches_jax(vlm):
    """Patches in front of the embedded tokens, positions over both; the
    hidden states come back for the text positions only."""
    cfg_j, cfg, params_j, params = vlm
    batch_j = _batch(cfg, seed=1)
    out_j, _, _ = jax.jit(lambda p, b: JM.forward_hidden(cfg_j, p, b, training=False))(
        params_j, batch_j)
    with torch.no_grad():
        out, _, aux = M.forward_hidden(cfg, params, _port_batch(batch_j))
    assert tuple(out.shape) == (BATCH, TEXT, cfg.d_model) and float(aux) == 0.0
    _close(out, out_j, "forward_hidden (text positions)")


def _jax_grow(cache_j, total_len):
    pad = lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, total_len - x.shape[2]), (0, 0), (0, 0)])
    return jax.tree.map(pad, cache_j)


def test_prefill_and_decode_match_jax(vlm, monkeypatch):
    """Prefill over 4 patches + 60 tokens (K3's wrapper once a layer, at
    every position), then 4 decode steps at positions prefix + 60 + i,
    against JAX's ``decode_step`` on JAX's cache grown to prefix + total."""
    cfg_j, cfg, params_j, params = vlm
    calls, real = [], transformer.flash_attention

    def counting(q, k, v, **kw):
        calls.append(q.shape[1])
        return real(q, k, v, **kw)

    monkeypatch.setattr(transformer, "flash_attention", counting)
    batch_j = _batch(cfg, seed=2)
    prefix = cfg.num_prefix_tokens
    logits_j, cache_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(params_j, batch_j)
    logits, cache = steps.make_prefill_step(cfg)(params, _port_batch(batch_j))
    assert calls == [prefix + TEXT] * cfg.num_layers
    err = float(np.abs(_f32(logits) - _f32(logits_j)).max())
    print(f"prefill logits max |diff| {err:.3g}")
    assert err <= LOGIT_TOL
    for key in ("k", "v"):
        assert cache["seg0"][key].shape[2] == prefix + TEXT
        _close(cache["seg0"][key], cache_j["seg0"][key], f"prefill cache {key}")

    cache = _grow_cache(cfg, cache, TEXT + GEN)
    assert cache["seg0"]["k"].shape[2] == prefix + TEXT + GEN
    cache_j = _jax_grow(cache_j, prefix + TEXT + GEN)
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    tok_j = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    worst = 0.0
    for i in range(GEN):
        pos = prefix + TEXT + i
        next_j, lj, cache_j = decode_j(params_j, cache_j, tok_j, jnp.asarray(pos, jnp.int32))
        next_tok, lt, cache = decode(params, cache, torch.tensor(np.asarray(tok_j)), pos)
        diff = float(np.abs(_f32(lt) - _f32(lj)).max())
        worst = max(worst, diff)
        assert diff <= LOGIT_TOL, (i, diff)
        top2 = np.sort(_f32(lj), axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
        assert (next_tok.numpy()[clear] == np.asarray(next_j)[clear]).all()
        tok_j = next_j
    assert len(calls) == cfg.num_layers  # decode attends with plain products
    print(f"decode logits max |diff| over {GEN} steps {worst:.3g}")


def test_decode_keeps_patches_where_jax_serve_wraps(vlm):
    """ROADMAP Queue 3: JAX's ``serve`` grows the cache to prompt + generated
    tokens, but the cache holds the patches too and decode writes at prompt
    + prefix + i, so once that passes the cache's length the write wraps
    (slot = pos % length) onto the first patches' K/V.  An 8-token prompt,
    6 steps; each decode's logits are held to JAX's own ``prefill`` over
    the patches, the prompt and the tokens so far: the port's within
    LOGIT_TOL at every step, JAX's serving path exact until it wraps, then
    off by more.  Attention chunk 128 on both sides, so JAX's prefill takes
    every length."""
    cfg_j, cfg, params_j, params = vlm
    cfg_j, cfg = (dataclasses.replace(c, attn_chunk=128) for c in (cfg_j, cfg))
    prompt_len, gen = 8, 6
    prefix = cfg.num_prefix_tokens
    batch_j = _batch(cfg, seed=3, text=prompt_len)
    prefill_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))
    logits_j, cache_j = prefill_j(params_j, batch_j)
    _, cache = steps.make_prefill_step(cfg)(params, _port_batch(batch_j))
    cache_jax_serve = jax_serve._grow_cache(cfg_j, cache_j, prompt_len + gen)
    length_j = cache_jax_serve["seg0"]["k"].shape[2]
    assert length_j == prompt_len + gen < prefix + prompt_len + gen
    cache = _grow_cache(cfg, cache, prompt_len + gen)
    assert cache["seg0"]["k"].shape[2] == prefix + prompt_len + gen
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    toks = np.asarray(batch_j["tokens"])
    tok = np.asarray(jnp.argmax(logits_j, axis=-1), np.int32)
    port_err, jax_err = [], []
    for i in range(gen):
        pos = prompt_len + prefix + i
        _, lj, cache_jax_serve = decode_j(params_j, cache_jax_serve, jnp.asarray(tok),
                                          jnp.asarray(pos, jnp.int32))
        _, lt, cache = decode(params, cache, torch.from_numpy(tok.copy()), pos)
        toks = np.concatenate([toks, tok[:, None]], axis=1)
        want, _ = prefill_j(params_j, {"patches": batch_j["patches"], "tokens": jnp.asarray(toks)})
        want = _f32(want)
        port_err.append(float(np.abs(_f32(lt) - want).max()))
        jax_err.append(float(np.abs(_f32(lj) - want).max()))
        tok = np.argmax(want, axis=-1).astype(np.int32)
    wraps = length_j - prompt_len - prefix  # the first step that writes at pos >= length
    print(f"decode logits vs JAX's prefill: port {np.round(port_err, 4).tolist()}, "
          f"JAX's serve path {np.round(jax_err, 4).tolist()} (wraps from step {wraps})")
    assert max(port_err) <= LOGIT_TOL
    assert max(jax_err[:wraps]) <= LOGIT_TOL
    assert max(jax_err[wraps:]) > 2 * LOGIT_TOL


def test_loss_and_grads_match_jax(vlm, monkeypatch):
    """``loss_fn`` over the text positions and its grads; training never
    calls K3's wrapper."""
    cfg_j, cfg, params_j, params = vlm

    def refuse(*args, **kwargs):
        raise AssertionError("training called flash_attention")

    monkeypatch.setattr(transformer, "flash_attention", refuse)
    batch_j = _batch(cfg, seed=4, labels=True)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j), has_aux=True))(params_j)
    grads, metrics = steps._value_and_grad(cfg, params, _port_batch(batch_j))
    rel = abs(float(metrics["loss"]) - float(loss_j)) / abs(float(loss_j))
    print(f"internvl2: loss {float(loss_j):.5f}, relative diff {rel:.3g} (limit {LOSS_RTOL})")
    assert rel <= LOSS_RTOL
    assert float(metrics["tokens"]) == float(metrics_j["tokens"]) == BATCH * TEXT - 3
    ours, theirs = dict(_flat(grads)), dict(_flat(grads_j))
    assert ours.keys() == theirs.keys()
    worst = max((_rel_l2(ours[p], g), p) for p, g in theirs.items())
    for path, g_j in theirs.items():
        assert ours[path].dtype == torch.bfloat16 and tuple(ours[path].shape) == g_j.shape
        assert _rel_l2(ours[path], g_j) <= GRAD_RTOL, path
    print(f"internvl2: worst grad relative L2 {worst[0]:.3g} at {worst[1]} (limit {GRAD_RTOL})")


def test_daemon_steps_match_jax():
    """3 DAEMON_AGGRESSIVE steps from the same converted state and batches,
    at d_model 128 (4 heads of 32, 2 kv heads) so the stacked weights are
    page class: each loss within LOSS_RTOL, the master within 2·Σlr, and a
    live residual."""
    cfg_j, cfg = (dataclasses.replace(c.reduced(), d_model=128, head_dim=32)
                  for c in (jax_get_config(ARCH), get_config(ARCH)))
    level = "DAEMON_AGGRESSIVE"
    n_steps = 3
    master_j = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(1))
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
        batch_j = _batch(cfg, seed=10 + i, labels=True)
        params_j, state_j, m_j = step_j(params_j, state_j, batch_j)
        params, state, m = step(params, state, _port_batch(batch_j))
        rel = abs(float(m["loss"]) - float(m_j["loss"])) / float(m_j["loss"])
        print(f"{level} step {i}: loss {float(m_j['loss']):.5f} rel diff {rel:.3g}")
        assert rel <= LOSS_RTOL
        lr_sum += float(m_j["lr"])
    ours, theirs = dict(_flat(state.master)), dict(_flat(state_j.master))
    assert ours.keys() == theirs.keys()
    worst = max(float(np.abs(_f32(ours[p]) - _f32(w)).max()) for p, w in theirs.items())
    print(f"{level}: master max |diff| {worst:.3g} (limit 2·Σlr = {2 * lr_sum:.3g})")
    assert worst <= 2 * lr_sum
    assert sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual)) > 0


def test_train_driver_runs_two_steps():
    """``train`` feeds zero patches in front of each batch, as JAX's does;
    patches + tokens must be a multiple of the attention chunk (32) above
    it, as in JAX, so seq_len is 60."""
    _, _, losses = train(ARCH, reduced=True, steps=2, global_batch=2, seq_len=60,
                         movement="daemon", device="cpu")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def test_serve_runs_internvl2():
    r = serve(ARCH, reduced=True, batch=2, prompt_len=16, gen_tokens=4, device="cpu")
    assert r["tokens"].shape == (2, 4) and ((r["tokens"] >= 0) & (r["tokens"] < 256)).all()
