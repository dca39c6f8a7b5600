"""The port's dry run (``repro_torch.launch.dryrun``) on reduced cells, on
fake tensors over a ``fake`` process group, against the JAX package's record
format and dot FLOPs.

  * ``run_cell`` owns its process group: it leaves none initialised, after a
    cell that ran and after one that failed, and refuses to start beside an
    initialised one; without CUDA its default device raises;
  * the reduced danube train cell at 1x1 (in process, one rank): JAX's
    record fields, and dot FLOPs 4 x JAX's HLO count at B = 2 (the reduced
    cell's batch is 8);
  * prefill and decode cells of danube and falcon-mamba at 1x1;
  * at (2, 1) with fsdp off, in a child process (a mesh of two ranks): the
    baseline gradient all-reduce moves the f32 gradient bytes.  XLA's
    partitioner and DTensor choose different collectives, so JAX's number
    is not held equal;
  * the DaeMon collectives under the op counter on two fake ranks, in a
    child process: ``c10d``'s all-reduce, all-to-all and all-gather reach it
    with the bytes ``block_quant.ops.wire_bytes`` gives;
  * ``benchmarks/roofline.py`` reads a written record through
    ``REPRO_DRYRUN_DIR``, unchanged.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.models import nn

ROOT = Path(__file__).resolve().parents[1]
DANUBE = "h2o-danube-1.8b"
JAX_TRAIN_DOT_FLOPS = 205_520_896  # JAX's HLO dot FLOPs at B = 2 (tests/test_torch_cost.py)
JAX_RECORD_KEYS = {
    "arch", "cell", "mesh", "kind", "movement", "n_devices", "ok", "microbatches", "lower_s",
    "compile_s", "flops", "hbm_bytes", "collective_bytes", "wire_bytes", "t_compute_s",
    "t_memory_s", "t_collective_s", "bottleneck", "collectives", "memory_analysis",
}


def _child(args, tmp_path, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2500:]
    return r.stdout


@pytest.fixture(scope="module")
def train_1x1():
    rec = dryrun.run_cell(DANUBE, "train_4k", "1x1", reduced=True, device="cpu")
    assert not dist.is_initialized()
    return rec


def test_train_record_has_jax_fields(train_1x1):
    rec = train_1x1
    assert rec["ok"], rec.get("traceback")
    assert JAX_RECORD_KEYS <= set(rec) and {"dot_flops", "kernel_launches"} <= set(rec)
    assert rec["compile_s"] == 0.0 and rec["lower_s"] > 0 and rec["microbatches"] == 1
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                           "temp_size_in_bytes", "alias_size_in_bytes"}
    n = M.param_count(get_config(DANUBE).reduced())
    # f32 params, m and v, the step count; tokens and labels (8 x 128 int32)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == 3 * 4 * n + 4 + 2 * 4 * 8 * 128
    assert rec["memory_analysis"]["alias_size_in_bytes"] == 3 * 4 * n + 4
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert "model_flops" not in rec  # reduced, as in JAX


def test_train_dot_flops_at_1x1_are_jax_times_the_batch(train_1x1):
    # the reduced cell's batch is max(8, 1 // 8) = 8, four times the B = 2 of JAX's count
    assert train_1x1["dot_flops"] == 4 * JAX_TRAIN_DOT_FLOPS
    assert train_1x1["collectives"]["counts"] == {} and train_1x1["kernel_launches"] == {}


@pytest.mark.parametrize("arch,cell", [(DANUBE, "prefill_32k"), (DANUBE, "decode_32k"),
                                       ("falcon-mamba-7b", "prefill_32k"),
                                       ("falcon-mamba-7b", "decode_32k")])
def test_serving_cells_run_at_one_rank(arch, cell):
    rec = dryrun.run_cell(arch, cell, "1x1", reduced=True, device="cpu")
    assert not dist.is_initialized()
    assert rec["ok"], rec.get("traceback")
    assert rec["flops"] > rec["dot_flops"] > 0 and rec["memory_analysis"]["temp_size_in_bytes"] > 0
    alias = rec["memory_analysis"]["alias_size_in_bytes"]
    if cell == "decode_32k":  # the cache is donated
        specs = M.cache_specs(get_config(arch).reduced(), 8, 128)
        assert alias >= nn.param_count(specs) * 2
    else:
        assert alias == 0


def test_failed_cell_leaves_no_process_group():
    rec = dryrun.run_cell(DANUBE, "train_4k", "1x1", reduced=True, device="cpu",
                          params_dtype="no_such_dtype")
    assert not dist.is_initialized()
    assert not rec["ok"] and "no_such_dtype" in rec["error"] and rec["traceback"]


def test_run_cell_refuses_an_initialised_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.run_cell(DANUBE, "train_4k", "1x1", reduced=True, device="cpu")
        assert dist.is_initialized()  # not destroyed: it is not run_cell's
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_default_device_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell(DANUBE, "train_4k", "1x1", reduced=True)
    assert not dist.is_initialized()


def test_grad_sync_bytes_at_2x1_and_benchmarks_roofline_reads_the_record(tmp_path):
    out = tmp_path / "dr"
    _child(["-m", "repro_torch.launch.dryrun", "--arch", DANUBE, "--cell", "train_4k",
            "--mesh", "2x1", "--reduced", "--no-fsdp", "--device", "cpu", "--out", str(out)],
           tmp_path)
    rec = json.loads((out / f"{DANUBE}_train_4k_2x1_baseline_reduced.json").read_text())
    assert rec["ok"] and rec["n_devices"] == 2
    cfg = get_config(DANUBE).reduced()
    leaves = nn.tree_leaves(M.model_specs(cfg))
    grad_bytes = 4 * M.param_count(cfg)  # every f32 gradient, summed over the data axis
    # and the three scalar metrics that leave the step whole: loss, ce, tokens
    assert rec["collectives"]["counts"] == {"all-reduce": len(leaves) + 3}
    assert rec["collectives"]["operand_bytes"] == {"all-reduce": grad_bytes + 3 * 4}
    assert rec["wire_bytes"] == 2 * rec["collective_bytes"]

    code = ("import json, benchmarks.roofline as r\n"
            "print(json.dumps(r.run()))\n")
    env_out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=60,
                             env=dict(os.environ, PYTHONPATH=str(ROOT),
                                      REPRO_DRYRUN_DIR=str(out)))
    assert env_out.returncode == 0, env_out.stderr
    rows = json.loads(env_out.stdout)
    assert len(rows) == 1
    tag, _, derived = rows[0]
    assert tag == f"roofline/{DANUBE}/train_4k/2x1/baseline"
    assert derived.startswith("t_comp=") and "bound=memory" in derived


def test_c10d_collectives_reach_the_counter(tmp_path):
    code = r"""
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core.movement.collectives import compressed_grad_sync
from repro_torch.launch import hlo_cost
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
try:
    out = {}
    with FakeTensorMode():
        g = torch.empty(1000)
        for mode in ("int8", "bf16"):
            c = hlo_cost.OpCounter()
            c.analyze(lambda: compressed_grad_sync(g, compress=mode))
            out[mode] = [c.counts()["collective_bytes"], c.counts()["collective_counts"]]
    print(json.dumps(out))
finally:
    dist.destroy_process_group()
"""
    got = json.loads(_child(["-c", code], tmp_path).splitlines()[-1])
    from repro_torch.kernels.block_quant.ops import wire_bytes

    # 1000 elements padded to 1024 (a 128-block a rank): codes and scales to
    # every peer, then each rank's reduced half gathered, int8 again
    assert got["int8"] == [{"all-to-all": wire_bytes((1024,)), "all-gather": wire_bytes((512,))},
                           {"all-to-all": 2, "all-gather": 2}]
    assert got["bf16"] == [{"all-reduce": 2 * 1000}, {"all-reduce": 1}]
