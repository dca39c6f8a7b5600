"""The MoE and hybrid families trained and served sharded over spawned gloo
ranks on the CPU, against one device: reduced deepseek-v2-lite-16b (MLA,
shared experts), dbrx-132b (GQA experts) and zamba2-1.2b (Mamba2 + the shared
attention block).  ``tools/sharded_ranks.py --device cpu --reduced`` runs the
ranks, twice side by side in one module fixture (4 ranks: the DaeMon step,
the gradients and ``serve`` at (2, 2); 2 ranks: ``serve`` at (1, 2)):

  * three DAEMON_AGGRESSIVE steps at (2, 2): losses within ``LOSS_RTOL`` of
    one device's, each rank holding the even split of master, m, v and
    residual;
  * every gradient leaf at (2, 2) within ``GRAD_TOL`` of its largest
    one-device magnitude;
  * ``serve`` at (2, 2) and (1, 2): the prefill's last logits within
    ``LOGIT_TOL``.

The MoE runs route as the one-device run routed (``sharded_ranks.Routes``):
the products on a mesh sum in another order, and reduced dbrx's near-tied
experts then flip; its router probabilities are held within 2e-2 of one
device's.  ``tests/test_torch_sharded_families_ssm.py`` holds the SSM, VLM
and enc-dec families.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's
LOGIT_TOL = 8e-2  # tests/test_torch_serve.py's
GRAD_TOL = 5e-2  # tests/test_torch_sharded_ranks.py's
RUN_SECONDS = 300  # about 30 s here
ARCHS = ["deepseek-v2-lite-16b", "dbrx-132b", "zamba2-1.2b"]

pytestmark = pytest.mark.slow


def run_ranks(archs):
    """The tool's two runs of ``archs`` side by side -> (outputs, checks keyed
    by (check, mesh, arch))."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]),
               OMP_NUM_THREADS="1")
    names = ",".join(archs)
    tool = [sys.executable, str(REPO / "tools" / "sharded_ranks.py"), "--device", "cpu",
            "--reduced", "--timeout", str(RUN_SECONDS - 60), "--serve-archs", names]
    jobs = {
        "ranks4": tool + ["--ranks", "4", "--train-archs", names, "--meshes", "2x2",
                          "--grads-meshes", "2x2", "--serve-meshes", "2x2"],
        "ranks2": tool + ["--ranks", "2", "--train-archs", "", "--meshes", "",
                          "--grads-meshes", "", "--serve-meshes", "1x2"],
    }
    procs = {k: subprocess.Popen(cmd, env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in jobs.items()}
    out, checks = {}, {}
    for k, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=RUN_SECONDS)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        out[k] = {"rc": p.returncode, "stdout": stdout, "stderr": stderr[-4000:]}
        for line in stdout.splitlines():
            if line.startswith("{") and '"check"' in line:
                line = json.loads(line)
                name = line.get("arch") or line.get("model")
                checks[(line["check"], tuple(line["mesh"]), name.replace("-reduced", ""))] = line
    return out, checks


@pytest.fixture(scope="module")
def runs():
    return run_ranks(ARCHS)


def check_runs_finish(runs):
    out, _ = runs
    for k, o in out.items():
        assert o["rc"] == 0, (k, o["stderr"])
        tool = [json.loads(line) for line in o["stdout"].splitlines() if '"tool"' in line]
        assert len(tool) == 1 and tool[0]["ok"], (k, tool)


def check_step(runs, arch):
    line = runs[1][("step", (2, 2), arch)]
    print(f"{arch} at (2, 2): {line['losses']}; one device {line['one_card_losses']}")
    assert line["ok"] and len(line["losses"]) == 3
    np.testing.assert_allclose(line["losses"], line["one_card_losses"], rtol=LOSS_RTOL)
    assert line["state_bytes_per_rank"] == [line["state_bytes_even_split"]] * 4
    for routes in line["routes_as_one_card_per_rank"]:
        assert not routes or routes["route_prob_max_dist"] <= 2e-2, routes


def check_grads(runs, arch):
    line = runs[1][("grads", (2, 2), arch)]
    print(f"{arch} grads at (2, 2): worst {line['worst_leaf']} {line['worst_rel']:.4f}")
    assert line["ok"] and line["worst_rel"] <= GRAD_TOL


def check_serve(runs, arch, mesh):
    line = runs[1][("serve", mesh, arch)]
    print(f"{arch} serve at {mesh}: logits {line['logits_max_abs_err']:.4f}")
    assert line["ok"] and line["logits_max_abs_err"] <= LOGIT_TOL


def test_the_rank_runs_finish(runs):
    check_runs_finish(runs)


@pytest.mark.parametrize("arch", ARCHS)
def test_daemon_step_at_2x2_matches_one_device(runs, arch):
    check_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_at_2x2_match_one_device(runs, arch):
    check_grads(runs, arch)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_a_mesh_matches_one_device(runs, arch, mesh):
    check_serve(runs, arch, mesh)
