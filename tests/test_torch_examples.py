"""The PyTorch twins of ``examples/train_lm.py`` and ``examples/serve_lm.py``
on the CPU, each in a child process: the training example checkpoints and
resumes where it stopped (checkpoints need ``zstandard``, as the JAX
package's do), the serving example prints JAX's two lines.  The training
runs take ``--batch 2 --seq 64`` to stay small."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args], cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-2500:]
    return r.stdout


def test_train_example_checkpoints_and_resumes(tmp_path):
    pytest.importorskip("zstandard", reason="checkpoints are zstandard-compressed")
    ck = tmp_path / "ck"
    small = ("--small", "--batch", "2", "--seq", "64", "--device", "cpu", "--ckpt-dir", str(ck))
    first = _run("train_lm_torch.py", "--steps", "30", *small, cwd=tmp_path)
    assert "training llama-8m:" in first and "movement=daemon" in first
    assert re.search(r"loss [\d.]+ -> [\d.]+ over 30 steps", first)
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000030"]
    again = _run("train_lm_torch.py", "--steps", "34", "--resume", *small, cwd=tmp_path)
    assert "resumed from step 30" in again and "step    31 loss" in again
    assert re.search(r"over 4 steps", again)
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000030", "step_00000034"]


def test_serve_example_prints_jax_lines(tmp_path):
    out = _run("serve_lm_torch.py", "--device", "cpu", cwd=tmp_path).splitlines()
    assert re.fullmatch(r"arch=qwen3-14b batch=4: prefill \d+ ms, decode [\d.]+ ms/token, "
                        r"throughput [\d.]+ tok/s", out[-2]), out
    assert out[-1] == "generated token matrix: (4, 24)"


def test_simulate_example_prints_jax_paper_claims(tmp_path):
    """The simulate twin at 2000 accesses a cell prints JAX's
    ``paper_claims`` at that size, line for line in the JAX example's
    format."""
    from repro.core.sim import paper_claims

    out = _run("simulate_daemon_torch.py", "--n-accesses", "2000", cwd=tmp_path).splitlines()
    r = paper_claims(n_accesses=2000)
    want = ["DaeMon vs page-granularity movement (paper claims: 2.39x perf, 3.06x access cost)"]
    for bw, row in r["per_bw"].items():
        per_w = " ".join(f"{w}:{v:.2f}" for w, v in row["per_workload"].items())
        want.append(f"  link bw = {bw:5.3f} x bus: perf {row['perf']:.2f}x  "
                    f"cost {row['cost']:.2f}x   [{per_w}]")
    want.append(f"  GEOMEAN: perf {r['perf_speedup_geomean']:.2f}x  "
                f"access-cost {r['access_cost_reduction_geomean']:.2f}x")
    assert out == want


def test_quickstart_twin_simulates_on_the_port_and_trains_on_the_cpu(tmp_path, capsys):
    """The simulate half prints the JAX quickstart's five lines; the train
    half runs on ``--device cpu``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("quickstart", ROOT / "examples" / "quickstart.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    quickstart.simulate()
    want = capsys.readouterr().out.splitlines()
    assert len(want) == 5
    out = _run("quickstart_torch.py", "--device", "cpu", cwd=tmp_path).splitlines()
    assert out[:5] == want
    assert out[5] == "=== tiny LM training with the daemon movement engine ==="
    assert re.fullmatch(r"  loss: [\d.]+ -> [\d.]+", out[-1]), out
