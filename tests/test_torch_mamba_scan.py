"""The port's selective scan (the plain version of kernel K4) against the JAX
package: the Pallas kernel in interpret mode, the ``selective_scan_ref``
oracle, and the model's chunked associative scan, on the same inputs, at
atol = rtol = 1e-4 as tests/test_kernels.py holds the Pallas kernel."""
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
