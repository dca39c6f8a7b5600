"""The port's selective scan (the plain version of kernel K4) against the JAX
package: the Pallas kernel in interpret mode, the ``selective_scan_ref``
oracle, and the model's chunked associative scan, on the same inputs, at
atol = rtol = 1e-4 as tests/test_kernels.py holds the Pallas kernel; and
K4's own arithmetic (exp on ex2.approx, its order of sums), emulated on the
CPU over sequences of 4096 steps and more, held to the same limit."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.kernels.mamba_scan.mamba_scan import selective_scan_pallas
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_scan_ref
from repro.models.mamba import intra_chunk_scan

from repro_torch.kernels.mamba_scan import kernel, selective_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4


def _inputs(b, s, d, n, seed=0, a_scale=0.5, dt_shift=-1.0):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, d)) + dt_shift)).astype(np.float32)
    a = (-np.exp(rng.normal(size=(d, n)) * a_scale)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    return dt, a, bm, cm, x


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,s,d,n,chunk", [
    (1, 128, 256, 16, 128),
    (2, 256, 256, 16, 128),
    (1, 256, 512, 8, 64),
])
def test_plain_scan_matches_pallas_and_oracle(b, s, d, n, chunk):
    inputs = _inputs(b, s, d, n, seed=s * d)
    y, h = selective_scan(*_torch(*inputs))
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (b, s, d) and tuple(h.shape) == (b, d, n)
    j = tuple(jnp.asarray(a) for a in inputs)
    y_p, h_p = selective_scan_pallas(*j, chunk=chunk, tile_d=256, interpret=True)
    y_r, h_r = jax_scan_ref(*j)
    for ours, theirs in ((y, y_p), (h, h_p), (y, y_r), (h, h_r)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,s,d,n", [(1, 200, 96, 16), (2, 37, 130, 8), (1, 64, 32, 4)])
def test_plain_scan_matches_oracle_on_ragged_shapes(b, s, d, n):
    """Shapes the Pallas kernel refuses (S % 128, D % 256) and the port takes."""
    inputs = _inputs(b, s, d, n, seed=7)
    y, h = selective_scan(*_torch(*inputs))
    y_r, h_r = jax_scan_ref(*(jnp.asarray(a) for a in inputs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=TOL, rtol=TOL)


def test_plain_scan_matches_model_chunked_path():
    """As tests/test_kernels.py does for the JAX oracle: the port's scan
    against the model's associative ``intra_chunk_scan``."""
    b, s, d, n = 1, 64, 32, 8
    dt, a, bm, cm, x = _inputs(b, s, d, n, seed=1, a_scale=0.3, dt_shift=0.0)
    jdt, ja, jbm, jcm, jx = (jnp.asarray(v) for v in (dt, a, bm, cm, x))
    da = jnp.exp(jdt[..., None] * ja)
    dbx = (jdt * jx)[..., None] * jbm[:, :, None, :]
    h_all, h_last = intra_chunk_scan(da, dbx, jnp.zeros((b, d, n)))
    y_assoc = jnp.einsum("bsdn,bsn->bsd", h_all, jcm)
    y, h = selective_scan(*_torch(dt, a, bm, cm, x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_assoc), atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_last), atol=TOL)


def test_plain_scan_takes_bf16_x_as_the_model_passes_it():
    """x arrives in bf16 from the model; both sides widen it to f32 first.
    A is falcon's s4d init, -(1..N) per channel."""
    b, s, d, n = 2, 96, 64, 16
    dt, _, bm, cm, x = _inputs(b, s, d, n, seed=3)
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (d, n)).copy()
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    y, h = selective_scan(*_torch(dt, a, bm, cm), tx)
    y_r, h_r = jax_scan_ref(jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm), jnp.asarray(cm), jx)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=TOL, rtol=TOL)


def test_cpu_tensors_take_the_plain_version():
    inputs = _torch(*_inputs(1, 40, 24, 4, seed=5))
    y, h = selective_scan(*inputs)
    y_r, h_r = selective_scan_ref(*inputs)
    assert torch.equal(y, y_r) and torch.equal(h, h_r)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernel.forward(*_torch(*_inputs(1, 16, 16, 4)))


# --------------------------------------------------------------------------
# K4's own arithmetic, emulated on the CPU
# --------------------------------------------------------------------------

KERNEL_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
                 / "mamba_scan" / "csrc" / "mamba_scan.cu")
# ex2.approx.f32 is within 2 ulp of 2^v (PTX ISA): a relative error under 2^-22
EX2_REL_ERR = 2.0 ** -22
LOG2E = np.float32(1.4426950408889634)


def _kernel_lanes() -> int:
    """Lanes per channel in K4 (``kLanes`` in its source): each lane sums
    its N / kLanes states of y_t, and a butterfly adds the lanes' sums."""
    return int(re.search(r"constexpr int kLanes = (\d+);", KERNEL_SOURCE.read_text()).group(1))


def _fma(a, b, c):
    """f32 fused multiply-add: the product is exact in f64, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _k4_emulation(dt, a, bm, cm, x, *, ex2_rel_err, lanes):
    """K4's reformulated arithmetic in plain PyTorch: da = 2^(dt·(A·log2 e))
    from two f32 products, every 2^v off by the relative error
    ``ex2_rel_err`` and flushed to 0 below 2^-126 (ex2.approx.ftz.f32);
    h = fma(da, h, (dt·x)·B); y_t summed over each lane's N / lanes states
    in order by fma from 0, then the lanes' sums added pairwise (the
    shuffle butterfly)."""
    dt, a, bm, cm, x = (torch.from_numpy(np.array(v, np.float32)) for v in (dt, a, bm, cm, x))
    b, s, d = dt.shape
    n = a.shape[1]
    a2 = a * torch.tensor(LOG2E)
    dx = dt * x
    h = torch.zeros(b, d, n)
    hs = torch.empty(s, b, d, n)
    for t in range(s):
        da = (torch.exp2((dt[:, t, :, None] * a2).double()) * (1 + ex2_rel_err)).float()
        da = torch.where(da < 2.0 ** -126, torch.zeros_like(da), da)
        h = _fma(da, h, dx[:, t, :, None] * bm[:, t, None, :])
        hs[t] = h
    c = cm.permute(1, 0, 2)[:, :, None, :]  # (S, B, 1, N)
    k = n // lanes
    sums = []
    for lane in range(lanes):
        acc = torch.zeros(s, b, d)
        for j in range(lane * k, (lane + 1) * k):
            acc = _fma(hs[..., j], c[..., j], acc)
        sums.append(acc)
    while len(sums) > 1:
        sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
    return sums[0].permute(1, 0, 2), h


def _falcon_inputs(b, s, d, n, seed):
    """falcon-mamba-7b's s4d A = -(1..N) per channel, dt over its dt_bias
    init range [1e-3, 1e-1], x rounded to bf16 as the model passes it."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(1e-3, 1e-1, size=(b, s, d)).astype(np.float32)
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (d, n)).copy()
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    x = np.array(jnp.asarray(rng.normal(size=(b, s, d)), jnp.bfloat16).astype(jnp.float32))
    return dt, a, bm, cm, x


@pytest.mark.parametrize("b,s,d,n,sign,kind", [
    (1, 4096, 8, 16, 1, "falcon"),
    (1, 4096, 8, 16, -1, "falcon"),
    (2, 4099, 6, 8, 1, "falcon"),
    (1, 4100, 4, 4, -1, "falcon"),
    (1, 4096, 8, 16, 1, "random"),
    (1, 4096, 8, 16, -1, "random"),
])
def test_k4_emulation_holds_the_limit_over_long_sequences(b, s, d, n, sign, kind):
    """K4's arithmetic, with every exp off by ex2.approx's bound in one
    direction (the worst case for error carried along the sequence), against
    the port's plain version and JAX's oracle at atol = rtol = 1e-4."""
    inputs = (_falcon_inputs(b, s, d, n, seed=s + n) if kind == "falcon"
              else _inputs(b, s, d, n, seed=s + n))
    y, h = _k4_emulation(*inputs, ex2_rel_err=sign * EX2_REL_ERR, lanes=_kernel_lanes())
    y_p, h_p = selective_scan_ref(*_torch(*inputs))
    y_j, h_j = jax_scan_ref(*(jnp.asarray(v) for v in inputs))
    for theirs_y, theirs_h in ((y_p.numpy(), h_p.numpy()), (np.asarray(y_j), np.asarray(h_j))):
        np.testing.assert_allclose(y.numpy(), theirs_y, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(h.numpy(), theirs_h, atol=TOL, rtol=TOL)


def test_k4_emulation_would_catch_a_coarser_exp():
    """The same check has teeth: an exp good to 2^-12 (a half-precision
    ex2) misses the limit over 4096 falcon steps."""
    inputs = _falcon_inputs(1, 4096, 8, 16, seed=11)
    y, _ = _k4_emulation(*inputs, ex2_rel_err=2.0 ** -12, lanes=_kernel_lanes())
    y_p, _ = selective_scan_ref(*_torch(*inputs))
    excess = ((y - y_p).abs() - TOL * y_p.abs()).max().item()
    assert excess > TOL, excess
