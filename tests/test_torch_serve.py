"""The port's dense serving path against the JAX package on the CPU: the same
JAX-initialised weights (bf16 working copy) and the same prompt go to both.

Prefill logits and every KV-cache buffer are compared, then 8 greedy decode
steps, both sides fed JAX's tokens, with the logits compared at each step.
Tolerance: both sides compute in bf16 (weights, activations, KV cache; f32
only for norms, softmax and accumulation), and round at different places (the
port's prefill attention keeps p in f32 as the flash kernel does, where JAX's
chunked attention rounds it to bf16), so values agree to a few bf16 ulps.
JAX disagrees with itself by as much: its jitted and its eager logits differ
by 0.028 at prefill and 0.033 at the first decode step on these inputs
(test_tolerance_covers_jax_own_spread; eager rounds every op to bf16, under
jit XLA keeps excess precision), and the port rounds as eager does in some
places and as jit does in others.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.configs import get_config as jax_get_config
from repro.core.movement import DAEMON_DEFAULT as JAX_DAEMON_DEFAULT
from repro.core.movement import working_copy as jax_working_copy
from repro.launch import steps as jax_steps
from repro.launch.serve import _grow_cache as jax_grow_cache
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps
from repro_torch.launch.serve import _grow_cache, serve

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 8e-2  # f32 logits of bf16 compute, O(1) in size: ~2x JAX's own spread
CACHE_TOL = 6e-2  # bf16 K/V reaching |4|: a few ulps there (0.016 each in [2, 4))
BATCH, PROMPT, GEN = 2, 32, 8


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# danube: SWA, window 16 < prompt 32, so prefill extracts a ring buffer and
# decode wraps it; qwen3: full attention + qk_norm; minicpm: tied embeddings
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen3-14b", "minicpm-2b"])
def test_prefill_and_decode_match_jax(arch):
    cfg_j = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    master = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0))
    params_j = jax_working_copy(master, JAX_DAEMON_DEFAULT)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    assert all(t.dtype == torch.bfloat16 for _, t in _flat(params))

    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    logits_j, cache_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(
        params_j, {"tokens": jnp.asarray(prompt, jnp.int32)}
    )
    logits, cache = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompt, dtype=torch.int32)}
    )
    err = np.abs(_f32(logits) - _f32(logits_j)).max()
    print(f"{arch} prefill logits max |diff| {err:.3g}")
    assert err <= LOGIT_TOL

    cache_leaves_j = dict(_flat(cache_j))
    cache_leaves = dict(_flat(cache))
    assert cache_leaves.keys() == cache_leaves_j.keys()
    for path, cj in cache_leaves_j.items():
        c = cache_leaves[path]
        assert tuple(c.shape) == cj.shape and c.dtype == torch.bfloat16
        cerr = np.abs(_f32(c) - _f32(cj)).max()
        print(f"{arch} cache {'/'.join(path)} max |diff| {cerr:.3g}, max |value| "
              f"{np.abs(_f32(cj)).max():.3g}")
        assert cerr <= CACHE_TOL

    cache_j = jax_grow_cache(cfg_j, cache_j, PROMPT + GEN)
    cache = _grow_cache(cfg, cache, PROMPT + GEN)
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    tok_j = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    worst = 0.0
    for i in range(GEN):
        pos = PROMPT + i
        next_j, step_logits_j, cache_j = decode_j(params_j, cache_j, tok_j, jnp.asarray(pos, jnp.int32))
        next_tok, step_logits, cache = decode(params, cache, torch.tensor(np.asarray(tok_j)), pos)
        lj, lt = _f32(step_logits_j), _f32(step_logits)
        worst = max(worst, float(np.abs(lt - lj).max()))
        assert np.abs(lt - lj).max() <= LOGIT_TOL, (i, np.abs(lt - lj).max())
        # greedy tokens agree wherever JAX's top-2 gap exceeds the tolerance
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
        assert (next_tok.numpy()[clear] == np.asarray(next_j)[clear]).all()
        tok_j = next_j
    print(f"{arch} decode logits max |diff| over {GEN} steps {worst:.3g}")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "falcon-mamba-7b"])
def test_tolerance_covers_jax_own_spread(arch):
    """JAX's jitted and eager runs of the same model differ (eager rounds every
    op to bf16); the tolerance must not be tighter than that spread.  The SSM
    cache is not grown: JAX's ``_grow_cache`` pads its conv tail (ROADMAP
    Queue 3)."""
    cfg = jax_get_config(arch).reduced()
    params = jax_working_copy(jnn.init_params(JM.model_specs(cfg), jax.random.key(0)),
                              JAX_DAEMON_DEFAULT)
    batch = {"tokens": jnp.asarray(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, PROMPT)), jnp.int32)}
    logits_jit, cache_jit = jax.jit(lambda p, b: JM.prefill(cfg, p, b))(params, batch)
    with jax.disable_jit():
        logits_eager, cache_eager = JM.prefill(cfg, params, batch)
    prefill_spread = float(np.abs(_f32(logits_jit) - _f32(logits_eager)).max())
    # one decode step: eager JAX takes seconds a step
    tok = jnp.argmax(logits_jit, axis=-1).astype(jnp.int32)
    pos = jnp.asarray(PROMPT, jnp.int32)
    decode = jax_steps.make_decode_step(cfg)

    def grow(cache):
        return cache if cfg.family == "ssm" else jax_grow_cache(cfg, cache, PROMPT + 1)

    _, l_jit, _ = jax.jit(decode)(params, grow(cache_jit), tok, pos)
    with jax.disable_jit():
        _, l_eager, _ = decode(params, grow(cache_eager), tok, pos)
    decode_spread = float(np.abs(_f32(l_jit) - _f32(l_eager)).max())
    print(f"{arch} JAX jit vs eager logits: prefill {prefill_spread:.3g}, "
          f"decode {decode_spread:.3g}")
    assert max(prefill_spread, decode_spread) <= LOGIT_TOL


def test_swa_prompt_shorter_than_window_mirrors_jax():
    """The _grow_cache edge (ROADMAP Queue 3): with prompt 12 < window 16 <
    12 + 12, the prefill cache is padded instead of kept as a ring, and decode
    attends past the window once pos >= 16.  The port keeps JAX's behaviour,
    so the two agree step by step; the distance from an exact sliding-window
    recompute of the same tokens is printed (run with -s)."""
    arch, prompt_len, gen = "h2o-danube-1.8b", 12, 12
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params_j = jax_working_copy(
        jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0)), JAX_DAEMON_DEFAULT
    )
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, prompt_len))
    logits_j, cache_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(
        params_j, {"tokens": jnp.asarray(prompt, jnp.int32)}
    )
    _, cache = steps.make_prefill_step(cfg)(params, {"tokens": torch.as_tensor(prompt)})
    cache_j = jax_grow_cache(cfg_j, cache_j, prompt_len + gen)
    cache = _grow_cache(cfg, cache, prompt_len + gen)
    assert cache["seg0"]["k"].shape[2] == cache_j["seg0"]["k"].shape[2] == prompt_len + gen
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    tokens = torch.as_tensor(prompt)
    tok_j = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    off_window = {}
    for i in range(gen):
        pos = prompt_len + i
        next_j, lj, cache_j = decode_j(params_j, cache_j, tok_j, jnp.asarray(pos, jnp.int32))
        tok = torch.tensor(np.asarray(tok_j))
        _, lt, cache = decode(params, cache, tok, pos)
        assert np.abs(_f32(lt) - _f32(lj)).max() <= LOGIT_TOL, pos
        tokens = torch.cat([tokens, tok[:, None].long()], dim=1)
        exact, _ = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
        off_window[pos] = float((lt - exact).abs().max())
        tok_j = next_j
    inside = max(v for p, v in off_window.items() if p < cfg.window)
    past = max(v for p, v in off_window.items() if p >= cfg.window)
    print(f"decode vs exact SWA: max |diff| {inside:.3g} at pos < {cfg.window}, "
          f"{past:.3g} at pos >= {cfg.window}")
    assert inside <= LOGIT_TOL


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "falcon-mamba-7b"])
def test_serve_runs_on_cpu_when_asked(arch):
    r = serve(arch, reduced=True, batch=2, prompt_len=32, gen_tokens=4, device="cpu")
    assert set(r) == {"tokens", "prefill_s", "decode_s_per_token", "tokens_per_s"}
    assert r["tokens"].shape == (2, 4) and r["tokens"].dtype == np.int32
    assert ((r["tokens"] >= 0) & (r["tokens"] < 256)).all()


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("h2o-danube-1.8b", reduced=True, batch=1, prompt_len=8, gen_tokens=2)


def test_serve_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="Sharding"):
        serve("h2o-danube-1.8b", reduced=True, mesh_shape=(2, 1), device="cpu")
