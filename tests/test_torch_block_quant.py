"""The port's block quantization (plain version of kernels K1/K2) against the
JAX oracle ``quantize_ref`` and the Pallas kernel in interpret mode, on the
same inputs.  Tolerances are those of tests/test_kernels.py: codes at most 1
apart on under 0.1 % of elements (XLA may divide through a reciprocal, one ulp
off, flipping exact .5 boundaries), scales within rtol 1e-6, dequantized
values within one scale step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from conftest import given, settings, st  # hypothesis-or-fallback shim

from repro.kernels.block_quant import ops as jax_ops
from repro.kernels.block_quant import ref as jax_ref
from repro.kernels.block_quant.block_quant import quantize_pallas

from repro_torch.kernels.block_quant import ops, ref

jax.config.update("jax_platform_name", "cpu")


def _inputs(r, c, dtype):
    """The same values on both sides: made in numpy, rounded to bf16 once."""
    x = np.random.default_rng(r * c).normal(size=(r, c)).astype(np.float32) * 3
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    return xj, xt.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _codes_close(q, q_other):
    a, b = np.asarray(q, np.int32), np.asarray(q_other, np.int32)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 1e-3


@pytest.mark.parametrize("r,c", [(8, 128), (256, 512), (300, 256), (1, 1024)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_matches_jax_ref_and_pallas(r, c, dtype):
    xj, xt = _inputs(r, c, dtype)
    q, s = ops.quantize(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (r, c // 128)
    for q_j, s_j in (jax_ref.quantize_ref(xj), quantize_pallas(xj, interpret=True)):
        _codes_close(q.numpy(), q_j)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-6)
    q_j, s_j = jax_ref.quantize_ref(xj)
    for out_t, out_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        x_t = ops.dequantize(q, s, out_t)
        x_j = jax_ref.dequantize_ref(q_j, s_j, out_j)
        assert x_t.dtype == out_t
        np.testing.assert_allclose(
            x_t.to(torch.float32).numpy(), np.asarray(x_j, np.float32),
            atol=float(np.asarray(s_j).max()) * 1.01,
        )


def test_quantize_flattens_like_jax():
    """Stacked (L, d_in, d_out) weights flatten to (L*d_in, d_out), as the
    working copy hands them over."""
    x = np.random.default_rng(0).normal(size=(3, 5, 256)).astype(np.float32)
    q, s = ops.quantize(torch.from_numpy(x))
    q_j, s_j = jax_ops.quantize(jnp.asarray(x))
    assert q.shape == q_j.shape and s.shape == s_j.shape == (3, 5, 2)
    _codes_close(q.numpy(), q_j)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-6)
    back = ops.dequantize(q, s, torch.bfloat16)
    assert back.shape == (3, 5, 256) and back.dtype == torch.bfloat16


def test_zero_block():
    q, s = ops.quantize(torch.zeros(8, 256))
    assert q.abs().sum() == 0 and s.abs().sum() == 0
    assert ops.dequantize(q, s).abs().sum() == 0


def test_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 512)).astype(np.float32))
    q, s = ops.quantize(x)
    xr = ops.dequantize(q, s)
    # absmax int8: |err| <= scale/2 = absmax/254 per block
    blocks = x.numpy().reshape(64, 4, 128)
    bound = np.abs(blocks).max(-1) / 254 + 1e-7
    err = np.abs(xr.numpy() - x.numpy()).reshape(64, 4, 128).max(-1)
    assert (err <= bound * 1.01).all()


@settings(max_examples=20, deadline=None)
@given(r=st.integers(1, 64), cb=st.integers(1, 6), scale=st.floats(1e-3, 1e3))
def test_roundtrip_property(r, cb, scale):
    """Round-trip error within the absmax/254 bound for any shape and range."""
    c = cb * 128
    x = np.random.default_rng(r * cb).normal(size=(r, c)).astype(np.float32) * scale
    q, s = ref.quantize_ref(torch.from_numpy(x))
    xr = ref.dequantize_ref(q, s).numpy()
    bound = np.abs(x.reshape(r, cb, 128)).max(-1, keepdims=True) / 254 + 1e-9
    assert (np.abs(xr - x).reshape(r, cb, 128) <= bound * 1.01 + 1e-7).all()


@pytest.mark.parametrize("shape", [(4096,), (24, 2560, 6912), (7, 128)])
def test_wire_bytes_matches_jax(shape):
    assert ops.wire_bytes(shape) == jax_ops.wire_bytes(shape)


def test_kernel_wrappers_take_only_cuda_tensors():
    """The launch wrappers never fall back: a CPU tensor is refused before
    any build or launch (``ops`` routes CPU tensors to the plain version)."""
    from repro_torch.kernels.block_quant import kernel

    with pytest.raises(ValueError, match="CUDA"):
        kernel.quantize(torch.zeros(2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dequantize(torch.zeros(2, 128, dtype=torch.int8), torch.zeros(2, 1))
