"""Cells, traffic mixes, metric readers and kernel-name lists are found by
name: one dropped in beside the others is found with no file edited."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from bench.harness import cells

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.traffic["kind"] in ("train", "serve_batches", "decode_sessions")
        assert cell.limits["numbers"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:  # each reports the end-to-end metric it moves
            assert any(e["name"] == m["moves"] for e in cell.end_to_end), (w["name"], m["name"])


def test_a_dropped_in_cell_is_found(tmp_path):
    """A copy of the benchmark plus a new cell's entry, traffic file, limits
    file, metric reader and kernel-name file, and nothing else changed: the
    harness finds each of them."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "minicpm-2b.new-mix", "config": "minicpm-2b",
                               "traffic": "new-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "model",
                               "moves": "decode_tokens_per_s",
                               "workloads": ["minicpm-2b.new-mix"]})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_tokens_per_s":
            m["workloads"].append("minicpm-2b.new-mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "bench/traffic/serve-decode-16x4k.json").read_text())
    traffic["sessions"] = 8
    (tmp_path / "bench/traffic/new-mix.json").write_text(json.dumps(traffic))
    (tmp_path / "bench/limits/minicpm-2b.new-mix.json").write_text(
        json.dumps({"numbers": {"served_token_gap": {"limit": 1.0}}}))
    (tmp_path / "bench/metrics/new_metric.py").write_text("def read(t):\n    return 42.0\n")
    (tmp_path / "bench/kernels/bq/another_kernel.txt").write_text("another_quantize_kernel\n")
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
            "from bench.harness import cells, driver, kernels\n"
            "c = cells.load('minicpm-2b.new-mix')\n"
            "print(c.traffic['sessions'], c.cfg['name'], [m['name'] for m in c.per_layer],\n"
            "      [m['name'] for m in c.end_to_end], driver.reader('new_metric')(None),\n"
            "      kernels.names('bq'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=tmp_path).stdout
    assert "8 minicpm-2b ['new_metric']" in out
    assert "'decode_tokens_per_s'" in out and "'setup_s'" in out and "42.0" in out
    assert "'another_quantize_kernel'" in out and "'quantize_kernel'" in out


def test_kernel_names_match_whole_identifiers():
    from bench.harness.kernels import names
    from bench.harness.trace import matches

    bq, k3 = names("bq"), names("k3")
    assert matches("void quantize_kernel<float>(float const*, signed char*)", bq)
    assert matches("void dequantize_kernel<__nv_bfloat16>(signed char const*)", bq)
    assert not matches("void dequantize_kernel_v2<float>()", ("dequantize_kernel",))
    assert matches("void flash_forward_wgmma_kernel<80>(TcParams)", k3)
    assert not matches("ampere_bf16_s16816gemm_bf16_128x128", bq + k3)
