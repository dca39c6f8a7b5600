"""The port sharded over spawned gloo ranks on the CPU, against one device and
against the JAX package sharded over fake devices.

``tools/sharded_ranks.py --device cpu --reduced`` runs the ranks; three runs
of it go side by side (two ranks twice, four ranks once), with a JAX
subprocess on 2 fake devices, in one module fixture:

  * the gradients at (2, 1), (1, 2), (2, 2) and (1, 4), every leaf against
    one device's;
  * the ``train`` entry point on reduced danube at (2, 1), (1, 2) and (2, 2)
    from JAX's initial master: its losses within ``LOSS_RTOL`` of the
    one-device run's, and at (2, 1) of JAX's ``train(..., mesh_shape=(2, 1))``;
  * the DaeMon step under DAEMON_AGGRESSIVE at (1, 2): losses within
    ``LOSS_RTOL``; each rank holds the even split of master, m, v and
    residual; the fold and the working copy bit for bit against one device,
    where reduced danube's ``w_gate``/``w_up`` shards split a 128-block;
  * ``serve`` at (1, 2), reduced danube (K3's plain version, the TP-local
    heads) and reduced falcon-mamba-7b (K4's, the TP-local channels): the
    prefill's logits within ``LOGIT_TOL``, the tokens equal;
  * a DaeMon run checkpointed at (2, 1) and resumed at (1, 2): steps 3-4
    within ``LOSS_RTOL`` of the uninterrupted run's; JAX's
    ``CheckpointManager`` loads that checkpoint, equal to the port's load.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
import jax

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.core import movement as jax_mv
from repro.models import model as JM
from repro.models import nn as jnn

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import movement as mv
from repro_torch.models import model as M
from repro_torch.models import nn

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-1.8b"
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's
LOGIT_TOL = 8e-2  # tests/test_torch_serve.py's
STEPS, BATCH, SEQ = 3, 4, 32

pytestmark = pytest.mark.slow

JAX_TRAIN = f"""
import contextlib, io, json
from repro.launch.train import train
with contextlib.redirect_stdout(io.StringIO()):
    _, _, losses = train({ARCH!r}, reduced=True, steps={STEPS}, global_batch={BATCH},
                         seq_len={SEQ}, mesh_shape=(2, 1), log_every=100)
print(json.dumps(losses))
"""


def _jax_master():
    cfg = jax_get_config(ARCH).reduced()
    return jnn.init_params(JM.model_specs(cfg), jax.random.key(0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): np.asarray(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    init = d / "init.npz"
    np.savez(init, **_flat(_jax_master()))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    tool = [sys.executable, str(REPO / "tools" / "sharded_ranks.py"), "--device", "cpu",
            "--reduced", "--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
            "--meshes", "", "--serve-meshes", "", "--grads-meshes", ""]
    jobs = {
        "driver": tool + ["--ranks", "2", "--driver-meshes", "2x1,1x2", "--init-npz", str(init),
                          "--resume", "2x1:1x2", "--ckpt-dir", str(d / "ckpt"),
                          "--grads-meshes", "2x1,1x2"],
        "step": tool + ["--ranks", "2", "--meshes", "1x2", "--fold-mesh", "1x2",
                        "--serve-meshes", "1x2",
                        "--serve-archs", f"{ARCH},falcon-mamba-7b"],
        "driver4": tool + ["--ranks", "4", "--driver-meshes", "2x2", "--init-npz", str(init),
                           "--grads-meshes", "2x2,1x4"],
        "jax": [sys.executable, "-c", JAX_TRAIN],
    }
    envs = {k: env for k in jobs}
    envs["jax"] = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = {k: subprocess.Popen(cmd, env=envs[k], cwd=str(REPO), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in jobs.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[k] = {"rc": p.returncode, "stdout": stdout, "stderr": stderr[-4000:]}
    lines = [json.loads(line) for k in ("driver", "step", "driver4")
             for line in out[k]["stdout"].splitlines() if line.startswith("{")]
    checks = {}
    for line in lines:
        if "check" in line:
            key = (line["check"], tuple(line.get("mesh") or line.get("resumed_on")),
                   line.get("arch"))
            checks[key] = line
    return {"out": out, "checks": checks, "ckpt": d / "ckpt",
            "jax_losses": json.loads(out["jax"]["stdout"].strip().splitlines()[-1])
            if out["jax"]["rc"] == 0 else None}


def test_the_rank_runs_finish(runs):
    for k, o in runs["out"].items():
        assert o["rc"] == 0, (k, o["stderr"])
    tools = [json.loads(line) for k in ("driver", "step", "driver4")
             for line in runs["out"][k]["stdout"].splitlines() if '"tool"' in line]
    assert len(tools) == 3 and all(t["ok"] for t in tools), tools


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_train_on_a_mesh_matches_one_device(runs, mesh):
    line = runs["checks"][("driver", mesh, None)]
    print(f"train at {mesh}: {line['losses']}; one device {line['one_device_losses']}")
    assert line["init"] == "npz" and len(line["losses"]) == STEPS
    np.testing.assert_allclose(line["losses"], line["one_device_losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2), (1, 4)])
def test_gradients_on_a_mesh_match_one_device(runs, mesh):
    """Every leaf's gradient, gathered: the losses alone would not show a
    gradient summed over too few ranks (AdamW normalises its scale).  At
    (1, 4) reduced danube's 2 KV heads are not split over the 4 ranks that
    split its 4 q heads, so each rank's K/V gradient is a partial sum."""
    line = runs["checks"][("grads", mesh, None)]
    print(f"grads at {mesh}: worst {line['worst_leaf']} {line['worst_rel']:.4f}")
    assert line["worst_rel"] <= line["grad_tol"] and line["ok"]
    assert len(line["rel_by_leaf"]) == 12  # every leaf of reduced danube


def test_train_at_2x1_matches_jax_at_2x1(runs):
    ours = runs["checks"][("driver", (2, 1), None)]["losses"]
    print(f"port at (2, 1): {ours}; JAX at (2, 1): {runs['jax_losses']}")
    assert runs["jax_losses"] is not None, runs["out"]["jax"]["stderr"]
    np.testing.assert_allclose(ours, runs["jax_losses"], rtol=LOSS_RTOL)


def test_daemon_step_on_a_mesh(runs):
    line = runs["checks"][("step", (1, 2), f"{ARCH}-reduced")]
    print(f"DAEMON_AGGRESSIVE at (1, 2): {line['losses']}; one device "
          f"{line['one_card_losses']}; state share a rank {line['state_share_per_rank']}")
    np.testing.assert_allclose(line["losses"], line["one_card_losses"], rtol=LOSS_RTOL)
    # every rank holds the even split of master, m, v and residual
    assert line["state_bytes_per_rank"] == [line["state_bytes_even_split"]] * 2
    assert all(0.5 <= s < 0.52 for s in line["state_share_per_rank"])
    assert all(line["launches_ok_per_rank"])


def test_fold_on_block_splitting_shards_is_bit_equal(runs):
    line = runs["checks"][("fold", (1, 2), None)]
    layouts = line["foldable_layouts"]
    # reduced danube's w_gate (2, 64, 128): mlp splits its last dim in halves
    assert layouts["seg0/ffn/w_gate"] == ["(Shard(dim=1), Shard(dim=2))",
                                          "(Shard(dim=1), Shard(dim=0))"]
    assert line["differing_leaves"] == [[], []] and line["ok"]


@pytest.mark.parametrize("arch", [ARCH, "falcon-mamba-7b"])
def test_serve_on_a_mesh_matches_one_device(runs, arch):
    line = runs["checks"][("serve", (1, 2), f"{arch}-reduced")]
    print(f"serve {arch} at (1, 2): logits within {line['logits_max_abs_err']:.4f}")
    assert line["tokens_equal"]
    assert line["logits_max_abs_err"] <= LOGIT_TOL


def test_checkpoint_saved_on_one_mesh_resumes_on_another(runs):
    line = runs["checks"][("resume", (1, 2), None)]
    print(f"saved at (2, 1), resumed at (1, 2): {line['resumed_losses']}; "
          f"uninterrupted {line['uninterrupted_losses'][2:]}")
    assert line["saved_on"] == [2, 1]
    np.testing.assert_allclose(line["resumed_losses"], line["uninterrupted_losses"][2:],
                               rtol=LOSS_RTOL)


def test_checkpoint_from_a_mesh_loads_in_jax(runs, ):
    pytest.importorskip("zstandard", reason="checkpoint save/restore needs zstandard")
    cfg_j = jax_get_config(ARCH).reduced()
    master = _jax_master()
    like_j = (jax_mv.working_copy(master, jax_mv.DAEMON_DEFAULT), jax_mv.init_state(master))
    restored, extra = jax_ckpt.CheckpointManager(runs["ckpt"]).restore(2, like_j)
    assert extra["step"] == 2 and cfg_j.name.startswith(ARCH)
    cfg = get_config(ARCH).reduced()
    m = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(0), torch.device("cpu"))
    like = (mv.working_copy(m, mv.DAEMON_DEFAULT), mv.init_state(m))
    ours, _ = CheckpointManager(runs["ckpt"]).restore(2, like)
    theirs = jax_ckpt._flatten(restored)
    mine = dict(ckpt._items(ours))
    assert sorted(mine) == sorted(theirs)
    for key, x in mine.items():
        a = ckpt.flatten({"x": x})["x"]
        b = np.asarray(theirs[key])
        if a.dtype == np.dtype("V2"):  # bf16 as bit patterns on both sides
            b = b.view(np.uint16).view(a.dtype) if b.dtype != a.dtype else b
        assert a.shape == b.shape and a.tobytes() == np.ascontiguousarray(b).tobytes(), key
