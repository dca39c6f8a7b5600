"""The readers of the model's attention ranges: ``attention_ms.train``,
``attention_ms.decode`` and ``attention_roofline.prefill``, on synthetic
trace summaries.  Each reads the device time under its ranges, and is
silent for another kind of traffic, where its range is missing, and where
the device time with no launch in the trace is 1 % of the range's or more
(a few stray kernels of a slice read on the card are far under it)."""
import pytest

from bench.harness.config import load
from bench.harness.driver import reader
from bench.harness.trace import TraceSummary
from bench.yardstick import costs

H100 = "NVIDIA H100 80GB HBM3"
K3 = "void (anonymous namespace)::flash_forward_wgmma_kernel<80>(...)"


def summary(kind: str, op_ms: dict, units: list, unattributed=None, cfg=None,
            kernels=None) -> TraceSummary:
    return TraceSummary(kernels=kernels or {}, op_ms=op_ms, busy_s=1.0, window_s=1.0,
                        launches=0, units=units, cfg=cfg or {}, traffic={"kind": kind},
                        device_kind=H100, unattributed=unattributed or {})


def test_train_attention_reads_forward_and_backward_per_step():
    read = reader("attention_ms.train")
    op_ms = {"attention.forward": 900.0, "attention.backward": 1_800.0, "aten::bmm": 2_000.0,
             "daemon_step.fold": 30.0}
    assert read(summary("train", op_ms, [{}] * 3)) == pytest.approx(900.0)
    assert read(summary("train", op_ms, [{}] * 3, unattributed={"sgemm": 1.4})) == 900.0
    assert read(summary("decode_sessions", op_ms, [{}] * 3)) is None
    assert read(summary("train", {"attention.forward": 900.0}, [{}] * 3)) is None
    assert read(summary("train", op_ms, [{}] * 3, unattributed={"sgemm": 27.0})) is None


def test_decode_attention_reads_its_range_per_step():
    read = reader("attention_ms.decode")
    op_ms = {"attention.decode": 3_840.0, "bench.decode_step": 4_320.0}
    assert read(summary("decode_sessions", op_ms, [{}] * 32)) == pytest.approx(120.0)
    assert read(summary("decode_sessions", op_ms, [{}] * 32, unattributed={"x": 0.1})) == 120.0
    assert read(summary("serve_batches", op_ms, [{}] * 32)) is None
    assert read(summary("decode_sessions", {"bench.decode_step": 4_320.0}, [{}] * 32)) is None
    assert read(summary("decode_sessions", op_ms, [{}] * 32, unattributed={"x": 38.4})) is None


def _prefill_units():
    return [{"batch": 4, "prompt_len": n, "ttft_s": 0.1} for n in (2048, 16384, 4096, 8192)]


def _prefill_bound_ms(cfg, units) -> float:
    h, kvh, d, window = costs.attention_shape(cfg)
    flop = sum(costs.k3_cost(b=u["batch"], sq=u["prompt_len"], skv=u["prompt_len"], h=h,
                             kvh=kvh, d=d, causal=True, window=window)[0] for u in units)
    return 1e3 * flop * cfg["num_hidden_layers"] / costs.peaks(H100)["bf16_flop_per_s"]


def test_prefill_attention_roofline_reads_the_range_whatever_kernel_runs():
    """Half the range's device time is the bound: 50 %.  With the same time
    in K3 alone, it reads what ``k3_roofline`` reads; with the range's time
    in another kernel, ``k3_roofline`` is silent and this is not."""
    read = reader("attention_roofline.prefill")
    cfg, units = load("h2o-danube-1.8b"), _prefill_units()
    bound = _prefill_bound_ms(cfg, units)
    layers = cfg["num_hidden_layers"]
    with_k3 = summary("serve_batches", {"attention.forward": 2 * bound}, units, cfg=cfg,
                      kernels={K3: [2 * bound, layers * len(units)]})
    assert read(with_k3) == pytest.approx(50.0)
    assert read(with_k3) == pytest.approx(reader("k3_roofline")(with_k3))
    other = summary("serve_batches", {"attention.forward": 4 * bound}, units, cfg=cfg,
                    kernels={"flash_fwd_kernel": [4 * bound, layers * len(units)]})
    assert read(other) == pytest.approx(25.0)
    assert reader("k3_roofline")(other) is None


def test_prefill_attention_roofline_is_silent_where_it_cannot_read():
    read = reader("attention_roofline.prefill")
    cfg, units = load("h2o-danube-1.8b"), _prefill_units()
    bound = _prefill_bound_ms(cfg, units)
    op_ms = {"attention.forward": 2 * bound}
    assert read(summary("train", op_ms, units, cfg=cfg)) is None
    assert read(summary("serve_batches", {"attention.decode": 2 * bound}, units, cfg=cfg)) is None
    cpu = summary("serve_batches", op_ms, units, cfg=cfg)
    cpu.device_kind = "cpu"
    assert read(cpu) is None
    # K3's launches unseen (made outside any host op): its time is in no
    # range, which holds only the output's allocation; the reading would
    # pass 100 %, so there is none
    unseen = summary("serve_batches", {"attention.forward": 0.01 * bound}, units, cfg=cfg,
                     unattributed={K3: 2 * bound})
    assert read(unseen) is None
    stray = summary("serve_batches", op_ms, units, cfg=cfg, unattributed={"fill": 1e-3 * bound})
    assert read(stray) == pytest.approx(50.0)
