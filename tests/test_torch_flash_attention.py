"""The port's attention (plain version of kernel K3, and the chunked
``nn.attention``) against the JAX package: the Pallas flash kernel in
interpret mode, the ``attention_ref`` oracle and ``nn.attention``, on the same
inputs.  f32 at atol = rtol = 2e-5 and bf16 at 2e-2, as tests/test_kernels.py
holds the Pallas kernel.  Then the rounding of K3's bf16 tensor-core kernel,
emulated in plain torch, against the plain version at the card's limit."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import nn as jnn

from repro_torch.kernels.flash_attention import flash_attention, kernel
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
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


# --------------------------------------------------------------------------
# The rounding of K3's bf16 tensor-core kernel, rehearsed on the CPU
# --------------------------------------------------------------------------

KERNEL_BK = 64  # keys per KV tile of the tensor-core kernel
LOG2E = 1.4426950408889634
# the long danube-like case: head_dim 80, GQA 4:1, a window shorter than S
LONG_CASE = (1, 2048, 2048, 4, 1, 80, True, 1024)


def _emulate_tensor_core_kernel(q, k, v, *, causal, window, split_p=True):
    """The arithmetic of csrc/flash_attention.cu's bf16 kernel in plain torch:
    S = Q K^T from bf16 operands with f32 sums, the online softmax over KV
    tiles of KERNEL_BK keys on the raw scores' running max m, with
    p = exp2(fma(s, c, -m c)) in the log2 domain (c = log2(e) / sqrt(D), the
    fma taken in f64 and rounded to f32), P rounded to bf16 as hi + lo (or
    once, ``split_p=False``), and O accumulated in f32, divided by l and
    rounded to bf16 at the end."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    heads = torch.arange(h) // (h // kvh)
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, Sq, D)
    kf = k.float()[:, :, heads].permute(0, 2, 1, 3)
    vf = v.float()[:, :, heads].permute(0, 2, 1, 3)
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, KERNEL_BK):
        kt, vt = kf[:, :, k0:k0 + KERNEL_BK], vf[:, :, k0:k0 + KERNEL_BK]
        x = torch.matmul(qf, kt.transpose(-1, -2))
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        x = x.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        live = m_new > NEG_INF / 2
        alpha = torch.where(live, torch.exp2((m - m_new) * scale_log2), torch.zeros(()))
        arg = (x.double() * scale_log2.double() - (m_new * scale_log2).double()).float()
        p = torch.where(live, torch.exp2(arg), torch.zeros(()))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.matmul(hi, vt)
        if split_p:
            pv = pv + torch.matmul((p - hi).to(torch.bfloat16).float(), vt)
        o = o * alpha + pv
        m = m_new
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


def _bf16_excess(case, split_p, seed=11):
    """max(|emulated - attention_ref| - 1e-2|ref|): the chip's bf16 limit for
    K3 is that this stays at or below 1e-5."""
    b, sq, skv, h, kvh, d, causal, window = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(b, sq, skv, h, kvh, d, seed))
    out = _emulate_tensor_core_kernel(q, k, v, causal=causal, window=window, split_p=split_p)
    ref = attention_ref(q, k, v, causal=causal, window=window).float()
    return float(((out.float() - ref).abs() - 1e-2 * ref.abs()).max())


@pytest.mark.parametrize("case", ATTN_CASES + [LONG_CASE])
def test_tensor_core_rounding_holds_the_chip_limit(case):
    """P as bf16 hi + lo keeps the kernel within one bf16 ulp of the plain
    version (f32 p): |err| <= 1e-5 + 1e-2|ref|, as chip_smoke.py holds it."""
    excess = _bf16_excess(case, split_p=True)
    print(f"{case}: split P excess over 1e-2|ref| = {excess:.3g}")
    assert excess <= 1e-5


def test_p_rounded_once_to_bf16_misses_the_chip_limit():
    """The reason for the split: p rounded once to bf16, as a textbook
    tensor-core flash kernel does, misses the same limit on the long case."""
    excess = _bf16_excess(LONG_CASE, split_p=False)
    print(f"{LONG_CASE}: P rounded once, excess over 1e-2|ref| = {excess:.3g}")
    assert excess > 1e-5


def test_tensor_core_emulation_matches_pallas_bf16():
    """The emulated kernel against the Pallas kernel in interpret mode (bf16,
    atol 2e-2 as tests/test_kernels.py holds it) on the danube geometry."""
    b, sq, skv, h, kvh, d, causal, window = ATTN_CASES[-1]
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(b, sq, skv, h, kvh, d, 7))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    out = _emulate_tensor_core_kernel(tq, tk, tv, causal=causal, window=window)
    pallas = flash_attention_pallas(q, k, v, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32), atol=2e-2)


def test_layout_rule_bf16_needs_strides_of_8():
    """The wrapper's layout rule, reached without a card: TMA needs 16-byte
    rows in bf16 (strides a multiple of 8 elements), f32 vector loads 4."""
    base = torch.empty(1, 8, 2, 20, dtype=torch.bfloat16)
    sliced = base[..., :16]  # strides (320, 40, 20, 1)
    assert kernel.layout_error("q", sliced.shape, sliced.stride(), torch.bfloat16,
                               sliced.data_ptr()) is not None
    assert kernel.layout_error("q", sliced.shape, sliced.stride(), torch.float32,
                               sliced.data_ptr()) is None
    assert kernel.layout_error("q", (1, 8, 2, 16), (256, 32, 16, 1), torch.bfloat16, 2) is not None
    assert kernel.layout_error("q", (1, 8, 16), (256, 32, 1), torch.bfloat16, 0) is not None


def test_serving_qkv_layout_suits_the_tensor_core_kernel():
    """The q, k, v that prefill hands K3 (gqa_qkv's outputs, bf16 as the
    working copy runs them) pass the TMA layout rule."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("h2o-danube-1.8b").reduced()
    layer = nn.init_params(transformer.attn_specs(cfg), torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    layer = nn.tree_map(lambda t: t.to(torch.bfloat16), layer)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    q, k, v = transformer.gqa_qkv(cfg, layer, x, torch.arange(40))
    for name, t in (("q", q), ("k", k), ("v", v)):
        assert kernel.layout_error(name, t.shape, t.stride(), t.dtype, t.data_ptr()) is None
