"""The port's dry run of every model family at 16x16 (TP 16), in process, at
reduced widths on fake CPU tensors: one ``train_4k`` and one ``prefill_32k``
of each family's archs, and deepseek's and zamba2's ``decode_32k``.  They
failed where a width does not divide 16 (4 heads, 8 SSM heads, 4 experts):
DTensor carried the row-parallel output projection's partial sums into the
next norm and split the tokens over ``model``, which later products could not
take; an MLA or shared-block reshape unflattened an uneven split.  JAX's dry
run lowers all of them.  See ``tests/test_torch_dryrun_families.py`` for the
2x2 and 2x2x2 cells.
"""
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from test_torch_dryrun_families import check_cell

ARCHS = ["h2o-danube-1.8b", "minicpm-2b", "falcon-mamba-7b", "deepseek-v2-lite-16b",
         "dbrx-132b", "zamba2-1.2b", "whisper-base", "internvl2-76b"]


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_trains_and_prefills_at_16x16(arch, cell):
    rec = check_cell(arch, cell, "16x16")
    assert rec["kind"] == cell.split("_")[0]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_moe_and_hybrid_decode_at_16x16(arch):
    check_cell(arch, "decode_32k", "16x16")
