"""The port's configs, movement engine, spec trees, basic ops and working copy
against the JAX package, on the same inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro import configs as jax_configs
from repro.core import movement as jax_mv
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.models import model as M
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

DENSE = ["minicpm-2b", "h2o-danube-1.8b", "stablelm-12b", "qwen3-14b"]
PORTED = DENSE + ["falcon-mamba-7b", "zamba2-1.2b", "deepseek-v2-lite-16b", "dbrx-132b",
                  "internvl2-76b", "whisper-base"]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --------------------------------------------------------------------------
# configs and the movement engine: copies, held field-equal
# --------------------------------------------------------------------------


def test_registry_matches_jax():
    assert configs.ARCHS == jax_configs.ARCHS
    assert [dataclasses.asdict(c) for c in configs.SHAPE_CELLS] == [
        dataclasses.asdict(c) for c in jax_configs.SHAPE_CELLS
    ]


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_config_fields_match_jax(arch):
    ours, theirs = configs.get_config(arch), jax_configs.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(theirs.reduced())
    assert ours.live_cells() == tuple(
        configs.ShapeCell(**dataclasses.asdict(c)) for c in theirs.live_cells()
    )


def test_movement_configs_match_jax():
    for name in ("BASELINE", "DAEMON_DEFAULT", "DAEMON_AGGRESSIVE"):
        assert dataclasses.asdict(getattr(mv, name)) == dataclasses.asdict(getattr(jax_mv, name))
        assert getattr(mv, name).cache_key() == getattr(jax_mv, name).cache_key()
    ours, theirs = mv.SelectionUnit(hold_steps=2), jax_mv.SelectionUnit(hold_steps=2)
    for step, ratio in enumerate([2.0, 2.0, 3.0, 0.1, 0.1, 0.1, 0.05, 0.5, 4.0]):
        a, b = ours.observe(step, ratio, 1.0), theirs.observe(step, ratio, 1.0)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ours.history == theirs.history


# --------------------------------------------------------------------------
# spec trees and parameter counts, at full size without allocation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PORTED)
def test_model_specs_match_jax(arch):
    ours = dict(_flat(M.model_specs(configs.get_config(arch))))
    theirs = dict(_flat(JM.model_specs(jax_configs.get_config(arch))))
    assert ours.keys() == theirs.keys()
    for path, spec in theirs.items():
        assert tuple(ours[path]) == tuple(spec), path
    cfg = configs.get_config(arch)
    for b, s in ((2, 8192), (1, 64)):
        ours_c = dict(_flat(M.cache_specs(cfg, b, s)))
        theirs_c = dict(_flat(JM.cache_specs(jax_configs.get_config(arch), b, s)))
        assert {p: tuple(c) for p, c in ours_c.items()} == {p: tuple(c) for p, c in theirs_c.items()}


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_jax(arch):
    cfg = configs.get_config(arch)
    expected = JM.param_count(jax_configs.get_config(arch))
    active = JM.param_count(jax_configs.get_config(arch), active_only=True)
    assert M.param_count(cfg) == cfg.param_count() == expected
    assert M.param_count(cfg, active_only=True) == cfg.active_param_count() == active
    assert (active < expected) == (cfg.family == "moe")


def test_danube_param_count():
    assert configs.get_config("h2o-danube-1.8b").param_count() == 1_831_201_280


def test_deepseek_param_count():
    cfg = configs.get_config("deepseek-v2-lite-16b")
    assert cfg.param_count() == 15_706_484_224
    assert cfg.active_param_count() == 2_661_150_208


@pytest.mark.parametrize("arch, count", [("internvl2-76b", 70_553_706_496),
                                         ("whisper-base", 83_194_368)])
def test_vlm_and_enc_dec_param_counts(arch, count):
    cfg = configs.get_config(arch)
    assert cfg.param_count() == M.param_count(cfg) == count
    assert JM.param_count(jax_configs.get_config(arch)) == count


# --------------------------------------------------------------------------
# basic ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x, scale = _rand(2, 5, 64), _rand(64, seed=1)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    out = nn.rms_norm(tx, torch.from_numpy(scale), 1e-5)
    ref = jnn.rms_norm(jx, jnp.asarray(scale), 1e-5)
    assert out.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.to(torch.float32).numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_sigmoid_rounds_as_jax():
    """On the bf16 inputs |x| <= 80, ``nn.sigmoid`` and ``nn.silu`` equal
    JAX's jitted ``sigmoid`` and ``silu`` bit for bit, once subnormal inputs
    and results are flushed to zero as XLA flushes them (two products land
    on the smallest normal, which XLA flushes).  XLA:CPU evaluates the
    bf16 logistic through bf16 intermediates, and the correctly rounded
    ``torch.sigmoid`` misses it on 1106 of these inputs.  In f32 within an
    ulp."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(jnp.bfloat16)
    x = bits.astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    keep = (np.abs(x) <= 80) & ((x == 0) | (np.abs(x) >= tiny))
    xj = jnp.asarray(bits[keep])
    xt = torch.from_numpy(x[keep]).to(torch.bfloat16)
    for ours, theirs in ((nn.sigmoid, jax.nn.sigmoid), (nn.silu, jnn.silu)):
        got = ours(xt).to(torch.float32).numpy()
        np.testing.assert_allclose(np.where(np.abs(got) < tiny, 0.0, got),
                                   np.asarray(jax.jit(theirs)(xj), np.float32), rtol=0, atol=tiny)
    assert int((torch.sigmoid(xt) != nn.sigmoid(xt)).sum()) == 1106
    x32 = _rand(4096) * 8
    np.testing.assert_allclose(nn.sigmoid(torch.from_numpy(x32)).numpy(),
                               np.asarray(jax.nn.sigmoid(jnp.asarray(x32))), rtol=2e-7, atol=0)


@pytest.mark.parametrize("name", ["sigmoid", "silu"])
def test_bf16_grad_is_finite_and_matches_jax(name):
    """The gradients of the bf16 ``nn.sigmoid`` and ``nn.silu`` on every bf16
    input in [-120, 40] are finite, also where exp(-x) overflows (x < -88.7),
    and equal JAX's jitted ``grad`` bit for bit, except on the inputs whose
    sigmoid is subnormal, which XLA flushes to zero."""
    ours, theirs = getattr(nn, name), {"sigmoid": jax.nn.sigmoid, "silu": jnn.silu}[name]
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(jnp.bfloat16)
    x = bits.astype(np.float32)
    keep = (x >= -120) & (x <= 40)
    xt = torch.from_numpy(x[keep]).to(torch.bfloat16).requires_grad_(True)
    ours(xt).sum().backward()
    got = xt.grad.to(torch.float32).numpy()
    assert np.isfinite(got).all()
    ref = np.asarray(jax.jit(jax.vmap(jax.grad(theirs)))(jnp.asarray(bits[keep])), np.float32)
    y = nn.sigmoid(xt.detach()).to(torch.float32).numpy()
    normal = (y == 0) | (y >= np.finfo(np.float32).tiny)
    assert (~normal).sum() < 64
    np.testing.assert_array_equal(got[normal], ref[normal])


def test_swiglu_matches_jax():
    x, wg, wu, wd = _rand(2, 3, 32), _rand(32, 48, seed=1), _rand(32, 48, seed=2), _rand(48, 32, seed=3)
    out = nn.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    ref = jnn.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    x = _rand(2, 40, 4, 80)
    positions = np.arange(8180, 8220)  # long positions: the serving path's
    out = nn.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), theta)
    ref = jnn.apply_rope(jnp.asarray(x), jnp.asarray(positions, jnp.int32), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


def test_init_params_shapes_and_scale():
    specs = M.model_specs(configs.get_config("h2o-danube-1.8b").reduced())
    params = nn.init_params(specs, torch.Generator().manual_seed(0), torch.device("cpu"))
    for (path, spec), (_, p) in zip(_flat(specs), _flat(params)):
        assert tuple(p.shape) == spec.shape and p.dtype == torch.float32, path
    assert torch.equal(params["ln_f"], torch.ones(64))
    w = params["seg0"]["ffn"]["w_down"]  # fan_in 128
    assert abs(w.std().item() * 128 ** 0.5 - 1.0) < 0.05


# --------------------------------------------------------------------------
# the DaeMon working copy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["DAEMON_DEFAULT", "DAEMON_AGGRESSIVE"])
def test_working_copy_matches_jax(level):
    cfg = jax_configs.get_config("h2o-danube-1.8b").reduced()
    master_j = jnn.init_params(JM.model_specs(cfg), jax.random.key(0))
    master = params_from_numpy(jax.tree.map(np.asarray, master_j), "cpu")
    masters = dict(_flat(master_j))
    ours = dict(_flat(mv.working_copy(master, getattr(mv, level))))
    theirs = dict(_flat(jax_mv.working_copy(master_j, getattr(jax_mv, level))))
    assert ours.keys() == theirs.keys()
    for path, w_j in theirs.items():
        w = ours[path]
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == w_j.shape
        a, b = w.to(torch.float32).numpy(), np.asarray(w_j, np.float32)
        if level == "DAEMON_DEFAULT" or w.dim() < 3:
            np.testing.assert_array_equal(a, b)  # a bf16 cast
        else:
            # int8 round trip: within one scale step (absmax/127 per block)
            step = np.abs(np.asarray(masters[path])).max() / 127
            np.testing.assert_allclose(a, b, atol=step * 1.01)
            assert (a != b).mean() < 1e-2
