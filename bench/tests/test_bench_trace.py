"""The trace's busy time inside named ranges, the readers built on it, and
the CPUs a run holds itself to."""
import pytest

from bench.harness.driver import reader
from bench.harness.trace import TraceSummary, _merge, _overlap_ns
from bench.run import cpu_pair


def summary(kind: str, busy, spans) -> TraceSummary:
    merged = _merge(busy)
    return TraceSummary(kernels={}, op_ms={}, busy_s=sum(e - s for s, e in merged) / 1e9,
                        window_s=1.0, launches=0, units=[{}], cfg={}, traffic={"kind": kind},
                        device_kind="cpu", spans=spans, busy_intervals=merged)


def test_overlap_of_merged_interval_lists():
    a = _merge([(0, 10), (5, 20), (30, 40)])
    assert a == [[0, 20], [30, 40]]
    assert _overlap_ns(a, _merge([(15, 35)])) == 5 + 5
    assert _overlap_ns(a, _merge([(20, 30), (41, 50)])) == 0
    assert _overlap_ns(a, a) == 30


def test_busy_in_counts_only_the_named_ranges():
    t = summary("serve_batches", busy=[(0, 300), (600, 700), (1_000, 1_900)],
                spans={"bench.prefill": [(0, 400), (1_000, 2_000)],
                       "bench.decode_step": [(400, 1_000)]})
    busy, span = t.busy_in("bench.prefill")
    assert busy == pytest.approx(1.2e-6) and span == pytest.approx(1.4e-6)
    assert t.busy_in("no.such_range") == (0.0, 0.0)


def test_prefill_idle_share_leaves_the_decode_steps_out():
    """Idle time in the decode steps after a prefill moves the whole
    window's idle share, not the prefills'."""
    spans = {"bench.prefill": [(0, 1_000)], "bench.decode_step": [(1_000, 2_000)]}
    read = reader("idle_share.prefill")
    busy_decode = summary("serve_batches", [(0, 800), (1_000, 1_900)], spans)
    idle_decode = summary("serve_batches", [(0, 800), (1_000, 1_100)], spans)
    assert read(busy_decode) == pytest.approx(20.0)
    assert read(idle_decode) == pytest.approx(20.0)
    assert read(summary("serve_batches", [(0, 800)], {})) is None
    assert read(summary("train", [(0, 800)], spans)) is None


@pytest.mark.parametrize("n,card,want", [
    (8, 0, [2, 3]), (8, 1, [4, 5]), (8, 3, [2, 3]), (32, 3, [8, 9]), (5, 1, [2, 3]),
    (4, 2, [2, 3]), (3, 0, [0, 1, 2]),
])
def test_each_card_gets_its_own_pair_of_cpus(n, card, want):
    assert cpu_pair(list(range(n)), card) == want
