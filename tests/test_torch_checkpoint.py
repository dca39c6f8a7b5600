"""The port's checkpointing against the JAX package's, on the CPU: the ports
of tests/test_substrates.py's checkpoint tests, checkpoints crossing between
the two packages in both directions (bit for bit, bf16 included), a save
without ``zstandard``, and the training driver's checkpoint and resume.

Leaves are made from a seed with numpy and handed to both sides.  Every
comparison is exact: a checkpoint stores bits, and the CPU training path is
deterministic, so a resumed run repeats the uninterrupted run's losses.
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.core import movement as jax_mv
from repro.models import model as JM
from repro.models import nn as jnn
from repro.optim import adamw as jax_adamw

from repro_torch.checkpoint import CheckpointManager, ckpt
from repro_torch.configs import get_config
from repro_torch.convert import adamw_state_from_numpy, daemon_state_from_numpy, params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

ARCH = "h2o-danube-1.8b"
N_KEYS = 61  # reduced danube's (params, DaemonState): 12 leaves x 5 trees + the step
HYBRID = "zamba2-1.2b"
# reduced zamba2 has 27 leaves (the trunk's 9 stacked Mamba2 and 15 shared-
# block ones, embed, ln_f, lm_head): (params, AdamWState) 3 trees + the step,
# (params, DaemonState) 5 trees + the step
N_KEYS_HYBRID = {"baseline": 3 * 27 + 1, "daemon": 5 * 27 + 1}


@pytest.fixture
def zstd():
    return pytest.importorskip("zstandard", reason="checkpoint save/restore needs zstandard")


def make_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
        "nested": {"b": torch.arange(10, dtype=torch.int32)},
    }


def _bits(x):
    """A leaf's bytes and manifest dtype: a torch tensor, a JAX array or a
    numpy array (bf16 as ``ml_dtypes`` or as its ``V2`` bit patterns)."""
    if isinstance(x, torch.Tensor):
        a = ckpt.flatten({"x": x})["x"]
    else:
        a = np.asarray(x)
    name = "bfloat16" if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2") else str(a.dtype)
    return a.shape, name, np.ascontiguousarray(a).tobytes()


def _jax_state(seed=0, arch=ARCH, movement="daemon"):
    """A reduced model's JAX (params, DaemonState), every leaf drawn from a
    seed (bf16 working copy, f32 master/moments/residual, int32 step); with
    ``movement="baseline"``, its (f32 params, AdamWState)."""
    cfg_j = jax_get_config(arch).reduced()
    master = jnn.init_params(JM.model_specs(cfg_j), jax.random.key(seed))
    if movement == "daemon":
        tree = (jax_mv.working_copy(master, jax_mv.DAEMON_DEFAULT), jax_mv.init_state(master))
    else:
        tree = (master, jax_adamw.init(master))
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return np.asarray(rng.integers(1, 1000), np.int32).reshape(a.shape)
        return np.asarray(rng.normal(size=a.shape), a.dtype)

    return jax.tree.map(draw, tree)


def _port_like(arch=ARCH):
    """The port's own (params, DaemonState) of a reduced model, zeros."""
    cfg = get_config(arch).reduced()
    master = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    state = mv.init_state(nn.tree_map(torch.zeros_like, master))
    return mv.working_copy(state.master, mv.DAEMON_DEFAULT), state


def _port_state(tree_j, movement="daemon"):
    params_j, state_j = tree_j
    if movement == "daemon":
        return params_from_numpy(params_j, "cpu"), daemon_state_from_numpy(state_j, "cpu")
    return params_from_numpy(params_j, "cpu"), adamw_state_from_numpy(state_j, "cpu")


# --------------------------------------------------------------------------
# tests/test_substrates.py:64-103, on the port
# --------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path, zstd):
    mgr = CheckpointManager(tmp_path)
    tree = make_tree()
    mgr.save(10, tree, {"step": 10})
    out, extra = mgr.restore(None, tree)
    assert extra["step"] == 10
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    assert out["nested"]["b"].dtype == torch.int32


def test_checkpoint_async_and_gc(tmp_path, zstd):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = make_tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree, {"step": s})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_save_async_snapshots_before_returning(tmp_path, zstd):
    """The train step writes its state in place after ``save_async``
    returns; the checkpoint holds the values at the call."""
    mgr = CheckpointManager(tmp_path)
    tree = make_tree()
    before = tree["a"].clone()
    mgr.save_async(1, tree)
    tree["a"].add_(1.0)
    mgr.wait()
    out, _ = mgr.restore(1, tree)
    assert torch.equal(out["a"], before)


def test_checkpoint_corruption_detected(tmp_path, zstd):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, make_tree())
    payload = tmp_path / "step_00000001" / "arrays" / "shard_0.npz.zst"
    data = bytearray(payload.read_bytes())
    data[10] ^= 0xFF
    payload.write_bytes(bytes(data))
    with pytest.raises(IOError):
        mgr.restore(1, make_tree())


def test_checkpoint_shape_mismatch_rejected(tmp_path, zstd):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, make_tree())
    bad = {"a": torch.zeros((4, 4)), "nested": {"b": torch.zeros(10, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        mgr.restore(1, bad)
    missing = {**make_tree(), "c": torch.zeros(3)}
    with pytest.raises(KeyError, match="'c'"):
        mgr.restore(1, missing)


def test_save_without_zstandard_raises_before_writing(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "zstandard", None)
    mgr = CheckpointManager(tmp_path / "ck")
    with pytest.raises(ImportError, match="zstandard"):
        mgr.save(1, make_tree())
    assert list((tmp_path / "ck").iterdir()) == []
    mgr.save_async(2, make_tree())
    with pytest.raises(ImportError, match="zstandard"):
        mgr.wait()
    assert list((tmp_path / "ck").iterdir()) == []


# --------------------------------------------------------------------------
# checkpoints crossing between the packages
# --------------------------------------------------------------------------


def test_keys_are_jax_path_strings():
    tree_j = _jax_state()
    keys_j = list(jax_ckpt._flatten(tree_j))
    keys = list(ckpt.flatten(_port_like()))
    assert keys == keys_j and len(keys) == N_KEYS
    for key in ("0/seg0/attn/wq", "1/.adam/.step", "1/.adam/.m/embed", "1/.adam/.v/ln_f",
                "1/.master/seg0/ffn/w_down", "1/.residual/lm_head"):
        assert key in keys, key


def test_jax_written_checkpoint_restores_in_the_port(tmp_path, zstd):
    tree_j = _jax_state(seed=1)
    jax_ckpt.CheckpointManager(tmp_path).save(7, tree_j, {"step": 7, "arch": ARCH})
    like = _port_like()
    (params, state), extra = CheckpointManager(tmp_path).restore(None, like)
    assert extra == {"step": 7, "arch": ARCH}
    assert isinstance(state, mv.DaemonState)
    ours = dict(ckpt._items((params, state)))
    theirs = jax_ckpt._flatten(tree_j)
    assert list(ours) == list(theirs)
    for key, a in theirs.items():
        t = ours[key]
        assert t.dtype == dict(ckpt._items(like))[key].dtype, key
        assert _bits(t) == _bits(a), key
    assert all(t.dtype == torch.bfloat16 for t in nn.tree_leaves(params))
    assert state.adam.step.dtype == torch.int32 and int(state.adam.step) == int(tree_j[1].adam.step)


def test_port_written_checkpoint_restores_in_jax(tmp_path, zstd):
    tree_j = _jax_state(seed=2)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_ckpt.CheckpointManager(jax_dir).save(3, tree_j)
    CheckpointManager(port_dir).save(3, _port_state(tree_j))
    manifests = [json.loads((d / "step_00000003" / "manifest.json").read_text())
                 for d in (jax_dir, port_dir)]
    assert manifests[1]["arrays"] == manifests[0]["arrays"]
    assert len(manifests[1]["arrays"]) == N_KEYS
    assert manifests[1]["arrays"]["0/embed"]["dtype"] == "bfloat16"

    restored, _ = jax_ckpt.CheckpointManager(port_dir).restore(3, tree_j)
    got, want = jax_ckpt._flatten(restored), jax_ckpt._flatten(tree_j)
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("movement", ["baseline", "daemon"])
def test_hybrid_port_save_restores_in_jax(tmp_path, zstd, movement):
    """Reduced zamba2's (params, AdamWState) and (params, DaemonState), saved
    by the port and restored by JAX: the same manifest and bytes.  JAX can
    use the baseline tree (all f32 but the int32 step) in its dtypes; it
    reads the daemon tree's bf16 leaves back as numpy void (ROADMAP Queue
    3), so there the bytes are held."""
    tree_j = _jax_state(seed=4, arch=HYBRID, movement=movement)
    CheckpointManager(tmp_path).save(5, _port_state(tree_j, movement), {"step": 5})
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert len(manifest["arrays"]) == N_KEYS_HYBRID[movement]
    assert "0/trunk/shared/lora_q_b" in manifest["arrays"]
    restored, extra = jax_ckpt.CheckpointManager(tmp_path).restore(5, tree_j)
    assert extra == {"step": 5}
    got, want = jax_ckpt._flatten(restored), jax_ckpt._flatten(tree_j)
    assert list(got) == list(want) == list(manifest["arrays"])
    for key in want:
        assert movement == "daemon" or got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape and got[key].tobytes() == want[key].tobytes(), key


def test_hybrid_jax_save_restores_in_port(tmp_path, zstd):
    """Reduced zamba2's DaeMon state (bf16 working copy, f32 master, moments
    and residual), saved by JAX and restored by the port bit for bit."""
    tree_j = _jax_state(seed=5, arch=HYBRID)
    jax_ckpt.CheckpointManager(tmp_path).save(9, tree_j, {"step": 9, "arch": HYBRID})
    like = _port_like(HYBRID)
    (params, state), extra = CheckpointManager(tmp_path).restore(None, like)
    assert extra == {"step": 9, "arch": HYBRID}
    ours, theirs = dict(ckpt._items((params, state))), jax_ckpt._flatten(tree_j)
    assert list(ours) == list(theirs) and len(ours) == N_KEYS_HYBRID["daemon"]
    for key, a in theirs.items():
        assert _bits(ours[key]) == _bits(a), key
    assert all(t.dtype == torch.bfloat16 for t in nn.tree_leaves(params))
    assert isinstance(state, mv.DaemonState) and int(state.adam.step) == int(tree_j[1].adam.step)


MOE = "deepseek-v2-lite-16b"


def test_moe_port_save_restores_in_jax(tmp_path, zstd):
    """Reduced deepseek's (params, DaemonState), saved by the port and
    restored by JAX: 4-D expert stacks (L, E, d, f) among the leaves, the
    bf16 working copy stored as numpy ``V2`` with manifest dtype "bfloat16",
    the same manifest and bytes."""
    tree_j = _jax_state(seed=6, arch=MOE)
    n_leaves = len(jax.tree.leaves(tree_j[0]))
    CheckpointManager(tmp_path).save(3, _port_state(tree_j), {"step": 3})
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert len(manifest["arrays"]) == 5 * n_leaves + 1
    for tree in ("0", "1/.master", "1/.adam/.m"):
        assert len(manifest["arrays"][f"{tree}/seg1/ffn/w_gate"]["shape"]) == 4
    assert manifest["arrays"]["0/seg1/ffn/w_up"]["dtype"] == "bfloat16"
    restored, extra = jax_ckpt.CheckpointManager(tmp_path).restore(3, tree_j)
    assert extra == {"step": 3}
    got, want = jax_ckpt._flatten(restored), jax_ckpt._flatten(tree_j)
    assert list(got) == list(want) == list(manifest["arrays"])
    for key in want:
        assert got[key].shape == want[key].shape and got[key].tobytes() == want[key].tobytes(), key


def test_moe_jax_save_restores_in_port(tmp_path, zstd):
    """Reduced deepseek's DaeMon state saved by JAX and restored by the port
    bit for bit, the bf16 working copy as bf16."""
    tree_j = _jax_state(seed=7, arch=MOE)
    jax_ckpt.CheckpointManager(tmp_path).save(11, tree_j, {"step": 11, "arch": MOE})
    (params, state), extra = CheckpointManager(tmp_path).restore(None, _port_like(MOE))
    assert extra == {"step": 11, "arch": MOE}
    ours, theirs = dict(ckpt._items((params, state))), jax_ckpt._flatten(tree_j)
    assert list(ours) == list(theirs)
    for key, a in theirs.items():
        assert _bits(ours[key]) == _bits(a), key
    assert all(t.dtype == torch.bfloat16 for t in nn.tree_leaves(params))
    assert params["seg1"]["ffn"]["w_down"].dim() == 4
    assert isinstance(state, mv.DaemonState) and int(state.adam.step) == int(tree_j[1].adam.step)


def test_uncompressed_serialisation_round_trips_bf16():
    """The payload the card phase round-trips without zstandard."""
    tree = _port_state(_jax_state(seed=3))
    flat = ckpt.flatten(tree)
    back = ckpt.unflatten_into(tree, ckpt.deserialize(ckpt.serialize(flat)),
                               {k: ckpt.dtype_name(a) for k, a in flat.items()})
    for (key, a), (_, b) in zip(ckpt._items(tree), ckpt._items(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), key


# --------------------------------------------------------------------------
# the training driver
# --------------------------------------------------------------------------


def test_train_driver_with_checkpoint_resume(tmp_path, zstd):
    """tests/test_substrates.py:172-197 on the port (baseline movement)."""
    kw = dict(reduced=True, global_batch=4, seq_len=32, ckpt_dir=str(tmp_path), ckpt_every=4,
              log_every=100, device="cpu")
    _, _, losses1 = train(ARCH, steps=8, **kw)
    assert len(losses1) == 8 and all(np.isfinite(losses1))
    assert CheckpointManager(tmp_path).all_steps() == [4, 8]
    # resume: continues from step 8's checkpoint without error
    _, _, losses2 = train(ARCH, steps=12, resume=True, **kw)
    assert len(losses2) == 4  # steps 8..12
    assert all(np.isfinite(losses2))
    assert CheckpointManager(tmp_path).all_steps() == [4, 8, 12]


class Interrupted(Exception):
    pass


def test_daemon_run_resumes_where_it_stopped(tmp_path, zstd, monkeypatch, capsys):
    """A daemon run (bf16 working copy) stopped by an error in its 9th step
    resumes from step 8's checkpoint, and its steps 9-12 repeat those of an
    uninterrupted 12-step run exactly, as do the final weights and state.
    (JAX cannot resume such a run: its restore returns the bf16 leaves as
    numpy void arrays.)"""
    kw = dict(reduced=True, steps=12, global_batch=4, seq_len=32, movement="daemon",
              log_every=100, device="cpu")
    params_full, state_full, full = train(ARCH, **kw)

    real = steps_lib.make_train_step

    def interrupted_at_9(*args, **kwargs):
        step, calls = real(*args, **kwargs), []

        def run(*a):
            calls.append(None)
            if len(calls) == 9:
                raise Interrupted("step 9")
            return step(*a)

        return run

    monkeypatch.setattr(steps_lib, "make_train_step", interrupted_at_9)
    with pytest.raises(Interrupted):
        train(ARCH, ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    monkeypatch.undo()
    assert CheckpointManager(tmp_path).all_steps() == [4, 8]

    capsys.readouterr()
    params, state, resumed = train(ARCH, ckpt_dir=str(tmp_path), ckpt_every=4, resume=True, **kw)
    assert "resumed from step 8" in capsys.readouterr().out
    print(f"uninterrupted steps 9-12 {full[8:]}; resumed {resumed}")
    assert resumed == full[8:]
    assert int(state.adam.step) == int(state_full.adam.step) == 12
    for (key, a), (_, b) in zip(ckpt._items((params_full, state_full)),
                                ckpt._items((params, state))):
        assert a.dtype == b.dtype and torch.equal(a, b), key
