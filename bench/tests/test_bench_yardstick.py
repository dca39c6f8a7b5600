"""The frozen yardstick gives the numbers PERF.md records for the port."""
import math

import pytest

from bench.harness.config import load
from bench.yardstick import costs

H100 = costs.peaks("NVIDIA H100 80GB HBM3")


def test_danube_training_step_flop():
    assert costs.train_flop(load("h2o-danube-1.8b"), 2, 4096) == pytest.approx(1.024e14, rel=5e-4)


@pytest.mark.parametrize("shape, flop", [
    ((2, 8192, 8192, 32, 8, 80, 4096), 5.154e11),   # danube's serving shape
    ((2, 8192, 8192, 40, 8, 128, 0), 1.375e12),     # qwen3-14b's
    ((2, 8192, 8192, 36, 36, 64, 0), 6.186e11),     # minicpm-2b's
])
def test_k3_flop(shape, flop):
    b, sq, skv, h, kvh, d, window = shape
    got, _ = costs.k3_cost(b=b, sq=sq, skv=skv, h=h, kvh=kvh, d=d, causal=True, window=window)
    assert got == pytest.approx(flop, rel=5e-4)


def test_k3_bound_of_danubes_shape():
    got, _ = costs.k3_cost(b=2, sq=8192, skv=8192, h=32, kvh=8, d=80, window=4096)
    assert got / H100["bf16_flop_per_s"] * 1e3 == pytest.approx(0.521, rel=2e-3)


def test_block_quant_bounds_of_a_danube_step():
    """A DAEMON_AGGRESSIVE step's 18 K1 and 18 K2 calls: 5.254 and 4.259 ms
    at 3.35 TB/s."""
    calls = costs.bq_step_calls(load("h2o-danube-1.8b"),
                                {"grad_sync": "int8", "expert_weights": "int8"})
    assert sum(k == "quantize" for k, _, _ in calls) == 18
    assert sum(k == "dequantize" for k, _, _ in calls) == 18
    for kind, ms in (("quantize", 5.254), ("dequantize", 4.259)):
        n_bytes = sum(costs.bq_cost(k, n, fb)[1] for k, n, fb in calls if k == kind)
        assert n_bytes / H100["hbm_bytes_per_s"] * 1e3 == pytest.approx(ms, rel=1e-3)


def test_band_pairs():
    assert costs.band_pairs(4096, 4096, True, 0) == 4096 * 4097 // 2
    assert costs.band_pairs(4096, 4096, True, 4096) == 4096 * 4097 // 2
    assert costs.band_pairs(10, 10, True, 3) == 1 + 2 + 3 * 8
    assert costs.band_pairs(10, 10, False, 0) == 100


def test_prefill_flop_counts_weights_head_and_attention():
    cfg = load("h2o-danube-1.8b")
    f = costs.prefill_flop(cfg, 4, 16384)
    layer = 24 * (2 * 2560 * 2560 + 2 * 2560 * 640 + 3 * 2560 * 6912)
    attn, _ = costs.k3_cost(b=4, sq=16384, skv=16384, h=32, kvh=8, d=80, window=4096)
    assert f == 2 * layer * 4 * 16384 + 2 * 2560 * 32000 * 4 + 24 * attn
    assert math.isclose(f, 2.7625e14, rel_tol=1e-4)


def test_unknown_device_has_no_peaks():
    assert costs.peaks("cpu") is None
