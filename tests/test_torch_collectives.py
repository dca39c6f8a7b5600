"""The port's DaeMon collectives (``repro_torch.core.movement.collectives``, on
``torch.distributed``) against the JAX package's (under ``shard_map``), on the
CPU with gloo and the plain K1/K2.

  * In process: one gloo rank (a ``FileStore`` in ``tmp_path``) against JAX
    over a one-device mesh, every function in every ``compress`` mode.
  * 8 ranks (``slow``): 8 spawned gloo ranks against JAX on 8 fake devices in
    a subprocess, mirroring tests/test_movement.py's three 8-device tests and
    their bounds.

The same inputs, made from a seed with numpy, go to both sides.  JAX runs
eagerly (``jax.disable_jit``): under ``jit`` XLA folds ``absmax / 127`` into a
product with the reciprocal, and its scales land one ulp off the IEEE
division that the Pallas kernel, the port's plain version and K1 compute.
Eagerly, every output is bit-equal to the port's, except ``g_mean`` across 8
ranks: the f32 mean of 8 contributions may be summed in another order, and
then its re-quantized codes may flip, so it is held within one int8 step of
its block's scale.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.core import movement as jax_mv

from repro_torch.core import movement as mv

jax.config.update("jax_platform_name", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["none", "bf16", "int8"]


def _shard_map(f, in_specs, out_specs):
    mesh = jax.make_mesh((1,), ("data",))
    if hasattr(jax, "shard_map"):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    from jax.experimental.shard_map import shard_map

    return shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def _jax_eager(f, in_specs, out_specs, *args):
    with jax.disable_jit():
        out = _shard_map(f, in_specs, out_specs)(*(jnp.asarray(a) for a in args))
    return jax.tree.map(np.asarray, out)


def _assert_bit_equal(ours, theirs, what):
    ours = ours.numpy()
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype, what
    assert ours.tobytes() == theirs.tobytes(), (what, float(np.abs(ours - theirs).max()))


@pytest.fixture
def world1(tmp_path):
    """This process as the only rank of a gloo group."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3


# (6, 100) is no multiple of 128: the int8 paths pad and strip
@pytest.mark.parametrize("compress", MODES)
@pytest.mark.parametrize("tiled", [True, False])
def test_compressed_all_gather_matches_jax(world1, compress, tiled):
    x = _x((6, 100), 0)
    ours = mv.compressed_all_gather(torch.from_numpy(x), compress=compress, tiled=tiled)
    spec = P("data") if tiled or compress == "int8" else P(None, "data")
    theirs = _jax_eager(lambda a: jax_mv.compressed_all_gather(a, "data", compress=compress,
                                                               tiled=tiled),
                        P("data"), spec, x)
    _assert_bit_equal(ours, theirs, compress)


@pytest.mark.parametrize("compress", MODES)
def test_compressed_grad_sync_matches_jax(world1, compress):
    g, r = _x((6, 100), 1), _x((6, 100), 2) * 0.01
    gm, new_res = mv.compressed_grad_sync(torch.from_numpy(g), None, torch.from_numpy(r),
                                          compress=compress)
    res_spec = P("data") if compress == "int8" else P()
    gm_j, res_j = _jax_eager(lambda a, b: jax_mv.compressed_grad_sync(a, "data", b,
                                                                      compress=compress),
                             (P("data"), P("data")), (P("data"), res_spec), g, r)
    _assert_bit_equal(gm, gm_j, "g_mean")
    _assert_bit_equal(new_res, res_j, "new_residual")
    if compress == "int8":
        assert float(new_res.abs().sum()) > 0  # error feedback is live


@pytest.mark.parametrize("compress", MODES)
def test_chunked_all_gather_matches_jax(world1, compress):
    x = _x((7, 100), 3)
    ours = mv.chunked_all_gather(torch.from_numpy(x), page_chunks=3, critical_rows=2,
                                 compress_pages=compress)
    theirs = _jax_eager(lambda a: jax_mv.chunked_all_gather(a, "data", page_chunks=3,
                                                            critical_rows=2,
                                                            compress_pages=compress),
                        P("data"), P("data"), x)
    _assert_bit_equal(ours, theirs, compress)


def test_unknown_compression_is_refused(world1):
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="compress"):
        mv.compressed_all_gather(x, compress="fp8")
    with pytest.raises(ValueError, match="compress"):
        mv.compressed_grad_sync(x, compress="fp8")


# --------------------------------------------------------------------------
# 8 ranks: tests/test_movement.py:41-110 on spawned gloo ranks, against JAX
# --------------------------------------------------------------------------

N_RANKS, EF_STEPS = 8, 6


def _inputs(path):
    """tests/test_movement.py's three global inputs, from numpy seeds."""
    rng = np.random.default_rng(0)
    np.savez(path, ag=rng.normal(size=(16, 256)).astype(np.float32),
             chunked=rng.normal(size=(24, 128)).astype(np.float32),
             grads=rng.normal(size=(N_RANKS * 8, 128)).astype(np.float32))


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import movement as mv

tmp, rank, n, ef_steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=n)
inp = np.load(f"{tmp}/inputs.npz")
out = {}
try:
    def shard(a):
        rows = a.shape[0] // n
        return torch.from_numpy(np.ascontiguousarray(a[rank * rows:(rank + 1) * rows]))

    out["ag"] = mv.compressed_all_gather(shard(inp["ag"]), compress="int8")
    x = shard(inp["chunked"])
    out["plain"] = mv.compressed_all_gather(x, compress="none")
    for c in ("bf16", "int8"):
        out[f"chunked_{c}"] = mv.chunked_all_gather(x, page_chunks=3, critical_rows=1,
                                                    compress_pages=c)
    g = shard(inp["grads"])
    res = torch.zeros_like(g)
    for i in range(ef_steps):
        out[f"gm{i}"], res = mv.compressed_grad_sync(g, None, res, compress="int8")
        out[f"res{i}"] = res
    np.savez(f"{tmp}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
finally:
    dist.destroy_process_group()
"""

_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import movement as mv
if hasattr(jax, "shard_map"):
    shard_map = jax.shard_map
else:
    from jax.experimental.shard_map import shard_map

tmp, ef_steps = sys.argv[1], int(sys.argv[2])
mesh = jax.make_mesh((%d,), ("data",))
inp = np.load(f"{tmp}/inputs.npz")
out = {}

def run(f, n_in, n_out, *args):
    fm = shard_map(f, mesh=mesh, in_specs=(P("data"),) * n_in,
                   out_specs=(P("data"),) * n_out if n_out > 1 else P("data"))
    return fm(*(jnp.asarray(a) for a in args))

with jax.disable_jit():
    out["ag"] = run(lambda a: mv.compressed_all_gather(a, "data", compress="int8"), 1, 1,
                    inp["ag"])
    for c in ("bf16", "int8"):
        out[f"chunked_{c}"] = run(lambda a: mv.chunked_all_gather(
            a, "data", page_chunks=3, critical_rows=1, compress_pages=c), 1, 1, inp["chunked"])
    res = np.zeros_like(inp["grads"])
    for i in range(ef_steps):
        out[f"gm{i}"], res = run(lambda a, b: mv.compressed_grad_sync(a, "data", b,
                                                                      compress="int8"),
                                 2, 2, inp["grads"], res)
        out[f"res{i}"] = res
np.savez(f"{tmp}/jax.npz", **{k: np.asarray(v) for k, v in out.items()})
""" % (N_RANKS, N_RANKS)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Every output of the 8 torch ranks and of JAX on 8 devices, run side by
    side: {"torch": [rank outputs], "jax": global outputs}."""
    tmp = tmp_path_factory.mktemp("eight_ranks")
    _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(tmp), str(EF_STEPS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp), str(r), str(N_RANKS),
                                str(EF_STEPS)], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for r in range(N_RANKS)]
    try:
        errors = []
        for p in procs:
            _, err = p.communicate(timeout=400)
            if p.returncode:
                errors.append(err[-3000:])
        assert not errors, "\n".join(errors)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_RANKS)]
    return {"torch": ranks, "jax": dict(np.load(tmp / "jax.npz")),
            "inputs": dict(np.load(tmp / "inputs.npz"))}


def _jax_shard(out, key, rank):
    a = out["jax"][key]
    rows = a.shape[0] // N_RANKS
    return a[rank * rows:(rank + 1) * rows]


@pytest.mark.slow
def test_compressed_all_gather_roundtrip_8_ranks(eight_ranks):
    x = eight_ranks["inputs"]["ag"]
    bound = np.abs(x).reshape(16, 2, 128).max(-1).max() / 127
    for r, out in enumerate(eight_ranks["torch"]):
        err = np.abs(out["ag"] - x).max()
        assert err <= bound * 1.01, (r, err, bound)
        assert out["ag"].tobytes() == _jax_shard(eight_ranks, "ag", r).tobytes(), r


@pytest.mark.slow
def test_chunked_all_gather_matches_plain_8_ranks(eight_ranks):
    for r, out in enumerate(eight_ranks["torch"]):
        np.testing.assert_array_equal(out["plain"], eight_ranks["inputs"]["chunked"])
        err = float(np.abs(out["chunked_bf16"] - out["plain"]).max())
        assert err < 0.02, (r, err)  # bf16 pages round at ~1e-2 relative
        for c in ("bf16", "int8"):
            key = f"chunked_{c}"
            assert out[key].tobytes() == _jax_shard(eight_ranks, key, r).tobytes(), (r, c)


@pytest.mark.slow
def test_compressed_grad_sync_error_feedback_converges_8_ranks(eight_ranks):
    """Error feedback: the mean of int8-synced grads over steps tracks the
    true mean; the residuals equal JAX's bit for bit at every step, and
    g_mean is within one int8 step of its block's scale of JAX's."""
    g_true = eight_ranks["inputs"]["grads"].reshape(N_RANKS, 8, 128)
    true_mean = g_true.mean(0)
    scale = np.abs(g_true).max() / 127
    worst, flips = 0.0, 0
    for r, out in enumerate(eight_ranks["torch"]):
        acc = sum(out[f"gm{i}"] for i in range(EF_STEPS))
        err = np.abs(acc / EF_STEPS - true_mean).max()
        assert err <= scale * 3, (r, err, scale)
        for i in range(EF_STEPS):
            res_j = _jax_shard(eight_ranks, f"res{i}", r)
            assert out[f"res{i}"].tobytes() == res_j.tobytes(), (r, i)
            gm_j = _jax_shard(eight_ranks, f"gm{i}", r).reshape(-1, 128)
            step = np.abs(gm_j).max(-1, keepdims=True) / 127  # the block's scale
            diff = np.abs(out[f"gm{i}"].reshape(-1, 128) - gm_j)
            assert (diff <= step * (1 + 1e-6)).all(), (r, i, float((diff - step).max()))
            worst = max(worst, float((diff / np.maximum(step, 1e-30)).max()))
            flips += int((diff > 0).sum())
    print(f"g_mean vs JAX: {flips} values differ, at most {worst:.3g} of their block's scale")
