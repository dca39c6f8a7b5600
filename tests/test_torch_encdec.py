"""The port's enc-dec family (whisper) against the JAX package on the CPU:
the sinusoidal table, the encoder, the teacher-forced decoder and its cache,
prefill and greedy decode, ``serve``'s grown cache, the loss and its grads, 3
DaeMon steps, and whisper checkpoints crossing between the two packages.

Reduced whisper: 2 encoder and 2 decoder layers, d_model 64, 4 heads of 16
(self-attention K/V with 2 kv heads, cross K/V with all 4), attention chunk
32.  JAX's ``nn.attention`` takes a sequence the chunk divides, so frames and
tokens are 64 long.  Tolerances: ``BF16_REL`` (four bf16 ulps of the largest
|value|) for one encoder or decoder pass; ``LOGIT_TOL`` 8e-2 for logits,
``LOSS_RTOL`` 1e-3 and ``GRAD_RTOL`` 3e-2 for training, the other families'
limits; checkpoints bit for bit.  Run with ``-s`` to print the distances.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.core import movement as jax_mv
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import encdec as jencdec
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.checkpoint import CheckpointManager, ckpt
from repro_torch.configs import get_config
from repro_torch.convert import daemon_state_from_numpy, params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.launch import steps
from repro_torch.launch.serve import _grow_cache, serve
from repro_torch.models import encdec, transformer
from repro_torch.models import model as M
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-base"
BF16_REL = 2.0 ** -6
LOGIT_TOL = 8e-2
LOSS_RTOL = 1e-3
GRAD_RTOL = 3e-2
BATCH, SEQ, GEN = 2, 64, 4


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


def _bf16(shape, seed, scale=1.0):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale, jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


@pytest.fixture(scope="module")
def whisper():
    """Reduced whisper: the JAX bf16 working copy and the port's load of it."""
    cfg_j, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    master = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0))
    params_j = jax_mv.working_copy(master, jax_mv.DAEMON_DEFAULT)
    return cfg_j, cfg, params_j, params_from_numpy(_np(params_j), "cpu")


def _inputs(cfg, seed=1, seq=SEQ):
    """Frames (bf16, both sides) and tokens, ``seq`` long."""
    fj, ft = _bf16((BATCH, seq, cfg.d_model), seed)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    return ({"frames": fj, "tokens": jnp.asarray(tokens)},
            {"frames": ft, "tokens": torch.as_tensor(tokens)})


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    labels[1, -3:] = -1
    frames = (rng.normal(size=(BATCH, SEQ, cfg.d_model)) * 0.5).astype(np.float32)
    return {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (BATCH, SEQ)), jnp.int32),
            "labels": jnp.asarray(labels, jnp.int32), "frames": jnp.asarray(frames, jnp.bfloat16)}


def _port_batch(batch_j):
    return {k: params_from_numpy(np.asarray(v), "cpu") for k, v in batch_j.items()}


# --------------------------------------------------------------------------
# sinusoidal positions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d_model", [512, 64])
def test_sinusoidal_pos_matches_jax(d_model):
    """The table at positions 0-2047 and one row at decode offsets, against
    JAX's jitted ``sinusoidal_pos`` (how the model calls it): within 1.2e-7
    (two f32 ulps of 1; measured 6e-8) and equal after the bf16 cast.  Under
    jit XLA turns the division by 10000^(2i/d) into a product with its
    reciprocal; the port does the same (dividing is 1.2e-4 off at 2047)."""
    table_j = np.asarray(jax.jit(lambda: jnn.sinusoidal_pos(2048, d_model))())
    table = nn.sinusoidal_pos(2048, d_model)
    assert table.dtype == torch.float32 and tuple(table.shape) == (2048, d_model)
    print(f"d_model {d_model}: max |diff| {np.abs(table.numpy() - table_j).max():.3g}")
    np.testing.assert_allclose(table.numpy(), table_j, rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(
        table.to(torch.bfloat16).to(torch.float32).numpy(),
        np.asarray(jnp.asarray(table_j).astype(jnp.bfloat16).astype(jnp.float32)))
    row_j = jax.jit(lambda o: jnn.sinusoidal_pos(1, d_model, offset=o))
    for off in (0, 1500, 1515, 2047):
        np.testing.assert_allclose(nn.sinusoidal_pos(1, d_model, off).numpy(),
                                   np.asarray(row_j(jnp.asarray(off, jnp.int32))),
                                   rtol=0, atol=1.2e-7)


# --------------------------------------------------------------------------
# encoder and teacher-forced decoder
# --------------------------------------------------------------------------


def test_encode_matches_jax(whisper):
    cfg_j, cfg, params_j, params = whisper
    bj, bt = _inputs(cfg)
    out_j = jax.jit(lambda p, f: jencdec.encode(cfg_j, p, f, training=False))(params_j, bj["frames"])
    out = encdec.encode(cfg, params, bt["frames"], training=False)
    assert out.dtype == torch.bfloat16
    _close(out, out_j, "encode")


def test_decode_train_matches_jax(whisper):
    """Hidden states and the cache: self K/V with kv heads, cross K/V with
    all heads, stacked over the decoder's layers."""
    cfg_j, cfg, params_j, params = whisper
    bj, bt = _inputs(cfg)
    enc_j, enc = _bf16((BATCH, SEQ, cfg.d_model), 3)
    out_j, cache_j = jax.jit(lambda p, t, e: jencdec.decode_train(
        cfg_j, p, t, e, training=False, make_cache=True))(params_j, bj["tokens"], enc_j)
    with torch.no_grad():
        out, cache = encdec.decode_train(cfg, params, bt["tokens"], enc, training=False,
                                         make_cache=True)
    _close(out, out_j, "decode_train hidden")
    specs = encdec.cache_specs(cfg, BATCH, SEQ)
    assert cache.keys() == cache_j.keys() == specs.keys()
    for key, spec in specs.items():
        assert tuple(cache[key].shape) == spec.shape, key
        _close(cache[key], cache_j[key], f"decode_train cache {key}")
    assert specs["ck"].shape[3] == cfg.num_heads != specs["k"].shape[3] == cfg.num_kv_heads


# --------------------------------------------------------------------------
# prefill, decode, serve
# --------------------------------------------------------------------------


def _jax_grow_self_kv(cache_j, total_len):
    """JAX's cache with only the self K/V padded to ``total_len``."""
    pad = lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, total_len - x.shape[2]), (0, 0), (0, 0)])
    return {**cache_j, "k": pad(cache_j["k"]), "v": pad(cache_j["v"])}


def test_prefill_and_decode_match_jax(whisper, monkeypatch):
    """JAX's prefill and ``decode_step`` against the port's, on JAX's cache
    with only ``k``/``v`` grown: prefill calls K3's wrapper 3 times a layer
    (encoder non-causal, decoder causal, cross non-causal), decode never."""
    cfg_j, cfg, params_j, params = whisper
    calls = []
    real = transformer.flash_attention

    def counting(q, k, v, *, causal=True, window=0):
        calls.append((causal, q.shape[1], k.shape[1], k.shape[2]))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(transformer, "flash_attention", counting)
    monkeypatch.setattr(encdec, "flash_attention", counting)
    bj, bt = _inputs(cfg)
    logits_j, cache_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(params_j, bj)
    logits, cache = steps.make_prefill_step(cfg)(params, bt)
    layers = cfg.enc_layers + 2 * cfg.dec_layers
    assert len(calls) == layers == 6
    assert sorted(set(calls)) == [(False, SEQ, SEQ, cfg.num_kv_heads),  # encoder
                                  (False, SEQ, SEQ, cfg.num_heads),  # cross
                                  (True, SEQ, SEQ, cfg.num_kv_heads)]  # decoder
    err = float(np.abs(_f32(logits) - _f32(logits_j)).max())
    print(f"prefill logits max |diff| {err:.3g}")
    assert err <= LOGIT_TOL
    for key in ("k", "v", "ck", "cv"):
        _close(cache[key], cache_j[key], f"prefill cache {key}")

    cache = _grow_cache(cfg, cache, SEQ + GEN)
    assert cache["k"].shape[2] == SEQ + GEN and cache["ck"].shape[2] == SEQ
    cache_j = _jax_grow_self_kv(cache_j, SEQ + GEN)
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    tok_j = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    worst = 0.0
    for i in range(GEN):
        pos = SEQ + i
        next_j, lj, cache_j = decode_j(params_j, cache_j, tok_j, jnp.asarray(pos, jnp.int32))
        next_tok, lt, cache = decode(params, cache, torch.tensor(np.asarray(tok_j)), pos)
        diff = float(np.abs(_f32(lt) - _f32(lj)).max())
        worst = max(worst, diff)
        assert diff <= LOGIT_TOL, (i, diff)
        top2 = np.sort(_f32(lj), axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
        assert (next_tok.numpy()[clear] == np.asarray(next_j)[clear]).all()
        tok_j = next_j
    assert len(calls) == layers
    print(f"decode logits max |diff| over {GEN} steps {worst:.3g}")
    _close(cache["k"], cache_j["k"], f"self K after {GEN} steps")


def test_decode_keeps_cross_kv_where_jax_serve_pads_it(whisper):
    """ROADMAP Queue 3: JAX's ``serve`` pads the cross K/V (``ck``/``cv``)
    with zero keys, which its decode attends to (no ``kv_len``).  On the same
    frames, the decode logits are held to JAX's own ``prefill`` over the
    prompt plus the tokens so far: the port's within LOGIT_TOL, JAX's serving
    path (its ``_grow_cache``, then ``decode_step``) off by more.  An
    8-token prompt and 8 frames, 6 steps; attention chunk 128 on both sides,
    so JAX's prefill takes every length."""
    cfg_j, cfg, params_j, params = whisper
    cfg_j, cfg = (dataclasses.replace(c, attn_chunk=128) for c in (cfg_j, cfg))
    prompt_len, gen = 8, 6
    bj, bt = _inputs(cfg, seed=4, seq=prompt_len)
    prefill_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))
    logits_j, cache_j = prefill_j(params_j, bj)
    _, cache = steps.make_prefill_step(cfg)(params, bt)
    total = prompt_len + gen
    cache_jax_serve = jax_serve._grow_cache(cfg_j, cache_j, total)
    assert cache_jax_serve["ck"].shape[2] == total  # padded with zero keys
    cache = _grow_cache(cfg, cache, total)
    assert cache["ck"].shape[2] == prompt_len
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    toks = np.asarray(bj["tokens"])
    tok = np.asarray(jnp.argmax(logits_j, axis=-1), np.int32)
    port_err, jax_err = [], []
    for i in range(gen):
        pos = prompt_len + i
        _, lj, cache_jax_serve = decode_j(params_j, cache_jax_serve, jnp.asarray(tok),
                                          jnp.asarray(pos, jnp.int32))
        _, lt, cache = decode(params, cache, torch.from_numpy(tok.copy()), pos)
        toks = np.concatenate([toks, tok[:, None]], axis=1)
        want, _ = prefill_j(params_j, {"frames": bj["frames"], "tokens": jnp.asarray(toks)})
        want = _f32(want)
        port_err.append(float(np.abs(_f32(lt) - want).max()))
        jax_err.append(float(np.abs(_f32(lj) - want).max()))
        tok = np.argmax(want, axis=-1).astype(np.int32)
    print(f"decode logits vs JAX's prefill: port {np.round(port_err, 4).tolist()}, "
          f"JAX's serve path {np.round(jax_err, 4).tolist()}")
    assert max(port_err) <= LOGIT_TOL
    assert min(jax_err) > 2 * LOGIT_TOL


def test_serve_runs_whisper():
    r = serve(ARCH, reduced=True, batch=2, prompt_len=16, gen_tokens=4, device="cpu")
    assert r["tokens"].shape == (2, 4) and ((r["tokens"] >= 0) & (r["tokens"] < 256)).all()


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def test_loss_and_grads_match_jax(whisper, monkeypatch):
    """``loss_fn`` and its grads; training attends through nn.attention and
    never calls K3's wrapper."""
    cfg_j, cfg, params_j, params = whisper

    def refuse(*args, **kwargs):
        raise AssertionError("training called flash_attention")

    monkeypatch.setattr(transformer, "flash_attention", refuse)
    monkeypatch.setattr(encdec, "flash_attention", refuse)
    batch_j = _batch(cfg, seed=5)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, batch_j), has_aux=True))(params_j)
    grads, metrics = steps._value_and_grad(cfg, params, _port_batch(batch_j))
    rel = abs(float(metrics["loss"]) - float(loss_j)) / abs(float(loss_j))
    print(f"whisper: loss {float(loss_j):.5f}, relative diff {rel:.3g} (limit {LOSS_RTOL})")
    assert rel <= LOSS_RTOL
    assert float(metrics["tokens"]) == float(metrics_j["tokens"]) == BATCH * SEQ - 3
    ours, theirs = dict(_flat(grads)), dict(_flat(grads_j))
    assert ours.keys() == theirs.keys()
    worst = max((_rel_l2(ours[p], g), p) for p, g in theirs.items())
    for path, g_j in theirs.items():
        assert ours[path].dtype == torch.bfloat16 and tuple(ours[path].shape) == g_j.shape
        assert _rel_l2(ours[path], g_j) <= GRAD_RTOL, path
    print(f"whisper: worst grad relative L2 {worst[0]:.3g} at {worst[1]} (limit {GRAD_RTOL})")


def test_daemon_steps_match_jax():
    """3 DAEMON_AGGRESSIVE steps from the same converted state and batches,
    at d_model 128 (4 heads of 32) so the attention, cross and FFN stacks
    are page class (int8 working copy) and their grads fold int8: each loss
    within LOSS_RTOL, the master within 2·Σlr as in
    ``tests/test_torch_train.py``, and a live residual."""
    cfg_j, cfg = (dataclasses.replace(c.reduced(), d_model=128, head_dim=32)
                  for c in (jax_get_config(ARCH), get_config(ARCH)))
    level = "DAEMON_AGGRESSIVE"
    n_steps = 3
    master_j = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(1))
    state_j = jax_mv.init_state(master_j)
    params_j = jax_mv.working_copy(master_j, getattr(jax_mv, level))
    state = daemon_state_from_numpy(_np(state_j), "cpu")
    params = mv.working_copy(state.master, getattr(mv, level))
    page = [p for p, leaf in _flat(state.master) if mv.daemon_step.is_page_class(tuple(leaf.shape))]
    print(f"page-class leaves: {len(page)}")
    assert ("dec", "cross", "wk") in page and ("enc", "attn", "wq") in page
    step_j = jax.jit(jax_steps.make_train_step(
        cfg_j, total_steps=n_steps, movement="daemon", movement_cfg=getattr(jax_mv, level)))
    step = steps.make_train_step(cfg, total_steps=n_steps, movement="daemon",
                                 movement_cfg=getattr(mv, level))
    lr_sum = 0.0
    for i in range(n_steps):
        batch_j = _batch(cfg, seed=10 + i)
        params_j, state_j, m_j = step_j(params_j, state_j, batch_j)
        params, state, m = step(params, state, _port_batch(batch_j))
        rel = abs(float(m["loss"]) - float(m_j["loss"])) / float(m_j["loss"])
        print(f"{level} step {i}: loss {float(m_j['loss']):.5f} rel diff {rel:.3g}")
        assert rel <= LOSS_RTOL
        np.testing.assert_allclose(float(m["lr"]), float(m_j["lr"]), rtol=1e-6)
        lr_sum += float(m_j["lr"])
    assert int(state.adam.step) == int(state_j.adam.step) == n_steps
    ours, theirs = dict(_flat(state.master)), dict(_flat(state_j.master))
    assert ours.keys() == theirs.keys()
    worst = max(float(np.abs(_f32(ours[p]) - _f32(w)).max()) for p, w in theirs.items())
    print(f"{level}: master max |diff| {worst:.3g} (limit 2·Σlr = {2 * lr_sum:.3g})")
    assert worst <= 2 * lr_sum
    assert sum(float(r.abs().sum()) for r in nn.tree_leaves(state.residual)) > 0


# --------------------------------------------------------------------------
# checkpoints, both ways
# --------------------------------------------------------------------------


def _jax_tree(seed):
    """Reduced whisper's JAX (bf16 working copy, DaemonState), every leaf
    drawn from a seed."""
    cfg_j = jax_get_config(ARCH).reduced()
    master = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(seed))
    tree = (jax_mv.working_copy(master, jax_mv.DAEMON_DEFAULT), jax_mv.init_state(master))
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return np.asarray(rng.integers(1, 1000), np.int32).reshape(a.shape)
        return np.asarray(rng.normal(size=a.shape), a.dtype)

    return jax.tree.map(draw, tree)


def _bits(x):
    a = ckpt.flatten({"x": x})["x"] if isinstance(x, torch.Tensor) else np.asarray(x)
    name = "bfloat16" if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2") else str(a.dtype)
    return a.shape, name, np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_crosses_jax(tmp_path, direction):
    """Reduced whisper's (params, DaemonState), the encoder's, decoder's and
    cross-attention's stacks among its keys, written by one package and
    restored by the other bit for bit."""
    pytest.importorskip("zstandard", reason="checkpoint save/restore needs zstandard")
    tree_j = _jax_tree(seed=3)
    params_j, state_j = tree_j
    ported = (params_from_numpy(params_j, "cpu"), daemon_state_from_numpy(state_j, "cpu"))
    n_keys = 5 * len(jax.tree.leaves(params_j)) + 1
    if direction == "port_to_jax":
        CheckpointManager(tmp_path).save(4, ported, {"step": 4})
        manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
        assert len(manifest["arrays"]) == n_keys
        assert manifest["arrays"]["0/dec/cross/wk"]["dtype"] == "bfloat16"
        restored, extra = jax_ckpt.CheckpointManager(tmp_path).restore(4, tree_j)
        assert extra == {"step": 4}
        got, want = jax_ckpt._flatten(restored), jax_ckpt._flatten(tree_j)
        assert list(got) == list(want) == list(manifest["arrays"])
        for key in want:
            assert got[key].shape == want[key].shape and got[key].tobytes() == want[key].tobytes()
    else:
        jax_ckpt.CheckpointManager(tmp_path).save(6, tree_j, {"step": 6, "arch": ARCH})
        like = nn.tree_map(torch.zeros_like, ported[0]), mv.init_state(
            nn.tree_map(torch.zeros_like, ported[1].master))
        (params, state), extra = CheckpointManager(tmp_path).restore(None, like)
        assert extra == {"step": 6, "arch": ARCH}
        ours, theirs = dict(ckpt._items((params, state))), jax_ckpt._flatten(tree_j)
        assert list(ours) == list(theirs) and len(ours) == n_keys
        for key, a in theirs.items():
            assert _bits(ours[key]) == _bits(a), key
        assert all(t.dtype == torch.bfloat16 for t in nn.tree_leaves(params))
        assert int(state.adam.step) == int(state_j.adam.step)
