"""What the benchmark runs loads neither JAX nor the JAX package, and its
reference loads nothing of the port."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from small import PREFILL

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"

RUN_SMALL = """
import sys, time, json
sys.path[:0] = [{tests!r}, {root!r}, {src!r}]
import torch
from small import small_cell
from bench.harness import driver
from bench.run import forbidden_modules
res = driver.run_cell(small_cell({cell!r}), 7, 0.5, True, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"correct": res["correct"], "forbidden": forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    """A traced run at a small size, through every module a run imports
    (harness, kinds, readers, reference, the port): no loaded module's
    top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro``, compared
    whole (``repro_torch`` is the port, and is loaded)."""
    code = RUN_SMALL.format(tests=str(BENCH / "tests"), root=str(ROOT), src=str(ROOT / "src"),
                            cell=PREFILL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    assert "repro_torch" in res["tops"] and "repro" not in res["tops"]
    assert not {"jax", "jaxlib", "flax"} & set(res["tops"])


def test_forbidden_names_compare_whole():
    from bench.run import FORBIDDEN, forbidden_modules

    assert "repro" in FORBIDDEN and "jax" in FORBIDDEN
    sys.modules["repro_torch_lookalike_for_test"] = sys.modules[__name__]
    try:
        assert "repro" not in forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike_for_test"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_no_bench_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "repro"), (path, mod)


def test_the_reference_imports_nothing_of_the_port():
    """Statically, and in a process that imports the reference alone."""
    for path in (BENCH / "reference").glob("*.py"):
        assert not any(m.split(".")[0] == "repro_torch" for m in _imports(path)), path
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "import bench.reference.llama, bench.reference.blockquant\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" not in tops and "repro" not in tops


def test_run_without_a_card_prints_no_result():
    """Where torch sees no CUDA card the command exits non-zero with nothing
    on standard output."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", PREFILL,
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
