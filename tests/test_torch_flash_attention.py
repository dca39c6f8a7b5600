"""The port's attention (plain version of kernel K3, and the chunked
``nn.attention``) against the JAX package: the Pallas flash kernel in
interpret mode, the ``attention_ref`` oracle and ``nn.attention``, on the same
inputs.  f32 at atol = rtol = 2e-5 and bf16 at 2e-2, as tests/test_kernels.py
holds the Pallas kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import nn as jnn

from repro_torch.kernels.flash_attention import flash_attention, kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

ATTN_CASES = [
    # (B, Sq, Skv, H, KVH, D, causal, window) — tests/test_kernels.py's five
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),  # GQA
    (1, 256, 256, 2, 1, 128, True, 128),  # SWA
    (1, 128, 256, 2, 2, 64, False, 0),  # cross-ish (non-causal, longer kv)
    (2, 128, 128, 4, 4, 32, True, 0),
    # danube geometry: H:KVH = 4:1, head_dim 80, window shorter than S
    (1, 256, 256, 8, 2, 80, True, 96),
]


def _qkv(b, sq, skv, h, kvh, d, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, d)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,window", ATTN_CASES)
def test_plain_flash_matches_pallas_and_oracle_f32(b, sq, skv, h, kvh, d, causal, window):
    q, k, v = _qkv(b, sq, skv, h, kvh, d)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, interpret=True)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, np.asarray(oracle), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", [ATTN_CASES[0], ATTN_CASES[-1]])
def test_plain_flash_matches_pallas_bf16(case):
    b, sq, skv, h, kvh, d, causal, window = case
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(b, sq, skv, h, kvh, d, 7))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    pallas = flash_attention_pallas(q, k, v, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), np.asarray(pallas, np.float32),
                               atol=2e-2)


def test_fully_masked_rows_give_zero():
    """Query rows past the last key by more than the window see no key: the
    kernels give 0 there (the JAX oracle's -inf would give NaN)."""
    q, k, v = _qkv(1, 64, 16, 2, 1, 16)
    out = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=True, window=8).numpy()
    assert np.isfinite(out).all()
    assert (out[:, 24:] == 0).all() and np.abs(out[:, :23]).min(axis=-1).max() > 0


def test_chunking_changes_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 256, 4, 2, 32))
    whole = attention_ref(q, k, v, causal=True, window=40)
    chunked = attention_ref(q, k, v, causal=True, window=40, chunk=64)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("q_offset,kv_len,chunk", [(0, None, 64), (5, 20, 1024), (31, 32, 1024)])
def test_nn_attention_matches_jax(q_offset, kv_len, chunk):
    sq = 128 if kv_len is None else 1
    q, k, v = _qkv(2, sq, 128 if kv_len is None else 40, 4, 2, 16, seed=3)
    causal = kv_len is None
    out = nn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       causal=causal, window=0, chunk=chunk, q_offset=q_offset, kv_len=kv_len)
    ref = jnn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        window=0, chunk=chunk, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_nn_attention_window_bf16_matches_jax():
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(1, 64, 64, 4, 2, 16, seed=5))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    out = nn.attention(tq, tk, tv, causal=True, window=16, chunk=32)
    ref = jnn.attention(q, k, v, causal=True, window=16, chunk=32)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), np.asarray(ref, np.float32),
                               atol=2e-2)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 2, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.forward(q, k, v, causal=True, window=0)
