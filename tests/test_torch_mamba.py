"""The port's Mamba1 family against the JAX package on the CPU: the block's
pieces on one JAX-initialised layer, then reduced falcon-mamba-7b end to end
(prefill logits, the SSM cache, 8 greedy decode steps, ``serve``'s cache).

Tolerances: both sides compute in bf16 (weights, activations, conv tail) with
the scan and the state in f32, and round at different places (JAX's chunked
associative scan against the port's sequential one; XLA under ``jit`` keeps
some sums in f32 that the port rounds, as JAX's own eager mode does), so
values agree to a few bf16 ulps of their scale: ``BF16_REL`` of the largest
|value| for activations and states.  Logits keep the dense family's 8e-2,
which ``tests/test_torch_serve.py::test_tolerance_covers_jax_own_spread``
measures against JAX's own jit-vs-eager spread on this model too.
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
from repro.models import mamba as jmamba
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import mamba
from repro_torch.models import model as M
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

ARCH = "falcon-mamba-7b"
LOGIT_TOL = 8e-2
BF16_REL = 2.0 ** -6  # four bf16 ulps (2^-8 each) of the largest |value|
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


def _close(ours, theirs, what):
    a, b = _f32(ours), _f32(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    print(f"{what}: max |diff| {err:.3g} at max |value| {scale:.3g}")
    assert err <= BF16_REL * scale, what


@pytest.fixture(scope="module")
def falcon():
    """Reduced falcon-mamba: the JAX bf16 working copy and the port's load of it."""
    cfg_j, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    params_j = jax_working_copy(jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0)),
                                JAX_DAEMON_DEFAULT)
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg, params_j, params


def _layer0(params_j, params):
    return (jax.tree.map(lambda a: a[0], params_j["blocks"]),
            {k: v[0] for k, v in params["blocks"].items()})


def _bf16(shape, seed, scale=1.0):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale, jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


# --------------------------------------------------------------------------
# inits
# --------------------------------------------------------------------------


def test_ssm_inits():
    """s4d equals JAX's init to an f32 ulp; dt_bias draws differ from jax.random but
    are the softplus inverse of U[1e-3, 1e-1]."""
    cfg = get_config(ARCH).reduced()
    specs = M.model_specs(cfg)
    params = nn.init_params(specs, torch.Generator().manual_seed(0), torch.device("cpu"))
    for (path, spec), (_, p) in zip(_flat(specs), _flat(params)):
        assert tuple(p.shape) == spec.shape and p.dtype == torch.float32, path
    params_j = jnn.init_params(JM.model_specs(jax_get_config(ARCH).reduced()), jax.random.key(0))
    np.testing.assert_allclose(params["blocks"]["A_log"].numpy(),  # log: within an ulp
                               np.asarray(params_j["blocks"]["A_log"]), rtol=2e-7, atol=0)
    dt = torch.nn.functional.softplus(params["blocks"]["dt_b"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert float(dt.std()) > 0.02  # spread over the range, not a constant


# --------------------------------------------------------------------------
# the block's pieces on one layer
# --------------------------------------------------------------------------


def test_causal_conv_matches_jax(falcon):
    cfg_j, cfg, params_j, params = falcon
    lj, lt = _layer0(params_j, params)
    xj, xt = _bf16((BATCH, 20, cfg.d_inner), 1)
    out = mamba.causal_conv(xt, lt["conv_w"], lt["conv_b"])
    assert out.dtype == torch.bfloat16
    _close(out, jax.jit(jmamba.causal_conv)(xj, lj["conv_w"], lj["conv_b"]), "causal_conv")


def test_causal_conv_step_matches_jax(falcon):
    cfg_j, cfg, params_j, params = falcon
    lj, lt = _layer0(params_j, params)
    xj, xt = _bf16((BATCH, cfg.d_inner), 2)
    tj, tt = _bf16((BATCH, cfg.ssm_conv - 1, cfg.d_inner), 3)
    out, tail = mamba.causal_conv_step(xt, tt, lt["conv_w"], lt["conv_b"])
    out_j, tail_j = jax.jit(jmamba.causal_conv_step)(xj, tj, lj["conv_w"], lj["conv_b"])
    _close(out, out_j, "causal_conv_step")
    np.testing.assert_array_equal(_f32(tail), _f32(tail_j))


@pytest.mark.parametrize("s", [2, 40])
def test_conv_tail_matches_jax(s):
    xj, xt = _bf16((BATCH, s, 16), 4)
    np.testing.assert_array_equal(_f32(mamba._conv_tail(xt, 4)), _f32(jmamba._conv_tail(xj, 4)))


def test_mamba1_forward_matches_jax(falcon):
    """S = 512 runs JAX's scan in two chunks of 256.  The residual input is
    small (the block normalises it), so rounding x + block to bf16 stays well
    under the block's own scale."""
    cfg_j, cfg, params_j, params = falcon
    lj, lt = _layer0(params_j, params)
    xj, xt = _bf16((BATCH, 512, cfg.d_model), 5, scale=0.1)
    forward_j = jax.jit(lambda p, x: jmamba.mamba1_forward(cfg_j, p, x, make_cache=True))
    out_j, cache_j = forward_j(lj, xj)
    out, cache = mamba.mamba1_forward(cfg, lt, xt, make_cache=True)
    assert out.dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    _close(out, out_j, "mamba1_forward output")
    _close(cache["state"], cache_j["state"], "mamba1_forward state")
    np.testing.assert_array_equal(_f32(cache["conv"]), _f32(cache_j["conv"]))  # raw inputs


def test_mamba1_decode_matches_jax(falcon):
    cfg_j, cfg, params_j, params = falcon
    lj, lt = _layer0(params_j, params)
    xj, xt = _bf16((BATCH, 1, cfg.d_model), 6, scale=0.1)
    tj, tt = _bf16((BATCH, cfg.ssm_conv - 1, cfg.d_inner), 7)
    state = np.random.default_rng(8).normal(size=(BATCH, cfg.d_inner, cfg.ssm_state)) * 0.01
    cache_j = {"state": jnp.asarray(state, jnp.float32), "conv": tj}
    cache = {"state": torch.from_numpy(state.astype(np.float32)), "conv": tt}
    out_j, new_j = jax.jit(lambda p, x, c: jmamba.mamba1_decode(cfg_j, p, x, c))(lj, xj, cache_j)
    out, new = mamba.mamba1_decode(cfg, lt, xt, cache)
    _close(out, out_j, "mamba1_decode output")
    _close(new["state"], new_j["state"], "mamba1_decode state")
    np.testing.assert_array_equal(_f32(new["conv"]), _f32(new_j["conv"]))


# --------------------------------------------------------------------------
# reduced falcon-mamba end to end
# --------------------------------------------------------------------------


def test_prefill_and_decode_match_jax(falcon):
    """Held against JAX's prefill and decode_step on JAX's ungrown cache: JAX's
    ``serve`` pads the conv tail in its ``_grow_cache`` and then fails."""
    cfg_j, cfg, params_j, params = falcon
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    logits_j, cache_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(
        params_j, {"tokens": jnp.asarray(prompt, jnp.int32)})
    logits, cache = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompt, dtype=torch.int32)})
    err = float(np.abs(_f32(logits) - _f32(logits_j)).max())
    print(f"prefill logits max |diff| {err:.3g}")
    assert err <= LOGIT_TOL
    assert cache["state"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    _close(cache["state"], cache_j["state"], "prefill state cache")
    _close(cache["conv"], cache_j["conv"], "prefill conv cache")

    cache = _grow_cache(cfg, cache, PROMPT + GEN)
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
    print(f"decode logits max |diff| over {GEN} steps {worst:.3g}")
    _close(cache["state"], cache_j["state"], f"state cache after {GEN} steps")


def test_grow_cache_leaves_ssm_caches_alone(falcon):
    """The port keeps every SSM leaf at ``cache_specs``' shape; JAX's
    ``_grow_cache`` pads the conv tail's axis 2 (ROADMAP Queue 3)."""
    cfg_j, cfg, params_j, params = falcon
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, 16))
    _, cache = steps.make_prefill_step(cfg)(params, {"tokens": torch.as_tensor(prompt)})
    grown = _grow_cache(cfg, cache, 16 + 4)
    specs = dict(_flat(M.cache_specs(cfg, BATCH, 16 + 4)))
    for path, leaf in _flat(grown):
        assert tuple(leaf.shape) == specs[path].shape, path
        assert leaf is dict(_flat(cache))[path]
    _, cache_j = JM.prefill(cfg_j, params_j, {"tokens": jnp.asarray(prompt, jnp.int32)})
    assert jax_grow_cache(cfg_j, cache_j, 16 + 4)["conv"].shape[2] == 16 + 4

