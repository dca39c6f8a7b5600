"""The port's dry run (``repro_torch.launch.dryrun.run_cell``) of every model
family on a mesh, in process, at reduced widths on fake CPU tensors: the
cells that failed where JAX's dry run lowers them.

  * at 2x2, the 11 cells that failed: the MoE family's ``train_4k`` and
    ``prefill_32k`` (``models/moe.py`` unbound its token groups along a
    dim split over ``data``), every cell of the hybrid family (the SSD
    body's einsum flattened a batch split and a head split into one strided
    split no product takes) and of the enc-dec (``sinusoidal_pos`` read a
    fake tensor through numpy);
  * at 2x2x2, one cell of each family, so the ``pod`` axis is laid out too.

``tests/test_torch_dryrun_families_tp16.py`` holds the 16x16 cells.  Each
record must be ``ok`` with positive FLOPs and HBM bytes, and leave no process
group behind; each cell has its own time limit.
"""
import contextlib
import signal

import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
import torch.distributed as dist

from repro_torch.launch import dryrun

CELL_SECONDS = 60  # about 7 s the slowest here, on one core

FAILED_AT_2X2 = [
    ("deepseek-v2-lite-16b", "train_4k"), ("deepseek-v2-lite-16b", "prefill_32k"),
    ("dbrx-132b", "train_4k"), ("dbrx-132b", "prefill_32k"),
    ("zamba2-1.2b", "train_4k"), ("zamba2-1.2b", "prefill_32k"),
    ("zamba2-1.2b", "decode_32k"), ("zamba2-1.2b", "long_500k"),
    ("whisper-base", "train_4k"), ("whisper-base", "prefill_32k"),
    ("whisper-base", "decode_32k"),
]
ONE_A_FAMILY = [  # dense, SSM, MoE, hybrid, VLM, enc-dec
    ("minicpm-2b", "train_4k"), ("falcon-mamba-7b", "prefill_32k"),
    ("deepseek-v2-lite-16b", "train_4k"), ("zamba2-1.2b", "train_4k"),
    ("internvl2-76b", "prefill_32k"), ("whisper-base", "train_4k"),
]


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise ``TimeoutError`` in the test if its body runs past ``seconds``."""

    def expire(signum, frame):
        raise TimeoutError(f"over {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def check_cell(arch: str, cell: str, mesh: str) -> dict:
    with time_limit(CELL_SECONDS):
        rec = dryrun.run_cell(arch, cell, mesh, reduced=True, device="cpu")
    assert not dist.is_initialized()
    assert rec["ok"], rec.get("traceback")
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0, rec
    assert rec["n_devices"] == int(torch.tensor([int(n) for n in mesh.split("x")]).prod())
    return rec


@pytest.mark.parametrize("arch,cell", FAILED_AT_2X2)
def test_cells_that_failed_at_2x2_run(arch, cell):
    check_cell(arch, cell, "2x2")


@pytest.mark.parametrize("arch,cell", ONE_A_FAMILY)
def test_one_cell_of_each_family_runs_at_2x2x2(arch, cell):
    rec = check_cell(arch, cell, "2x2x2")
    if cell == "train_4k":  # the gradients cross the data-parallel axes
        assert rec["collective_bytes"] > 0, rec
