"""The SSM, VLM and enc-dec families trained and served sharded over spawned
gloo ranks on the CPU, against one device: reduced falcon-mamba-7b (Mamba1:
``ssm_inner`` over ``model``, K4's plain version on each rank's channels at
prefill), internvl2-76b (patches in front of the text) and whisper-base
(encoder, decoder and cross-attention on local heads).  The same checks as
``tests/test_torch_sharded_families.py``, through its helpers.
"""
import pytest

pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from test_torch_sharded_families import (check_grads, check_runs_finish, check_serve,
                                         check_step, run_ranks)

ARCHS = ["falcon-mamba-7b", "internvl2-76b", "whisper-base"]

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def runs():
    return run_ranks(ARCHS)


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
