"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
examples' torch twins (``examples/*_torch.py``) import nothing of JAX and
nothing of the JAX package ``repro`` or of ``benchmarks``."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro", "benchmarks")


def _port_files():
    twins = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(twins) == 4, twins
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + twins


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_imports_in_the_source():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_every_module_imports_with_jax_and_repro_blocked():
    pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
    modules =["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], prefix="repro_torch.")
    ]
    for m in ("repro_torch.launch.serve", "repro_torch.models.mamba",
              "repro_torch.kernels.mamba_scan.kernel", "repro_torch.kernels.mamba_scan.ref",
              "repro_torch.core.sim.engine_batch"):
        assert m in modules, m
    assert len(modules) > 30
    code = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # makes `import name` raise ImportError\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_every_kernel_source_is_in_the_checkout_with_a_counter():
    """``chip_smoke.py`` builds every entry of ``runtime.SOURCES`` from the
    checkout: each is a ``.cu`` file under the package with a plain C
    interface, and each launch counter names one of them.  Each source note
    names the Pallas kernel it replaces, or says it replaces none (K5, the
    training backward: the Pallas kernel has no backward)."""
    pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
    from repro_torch.kernels import runtime

    assert set(runtime.SOURCES) == {"block_quant", "flash_attention", "flash_attention_bwd",
                                    "mamba_scan"}
    for name, path in runtime.SOURCES.items():
        assert path.is_file() and path.suffix == ".cu" and PORT in path.parents, name
        text = path.read_text()
        assert 'extern "C"' in text and "repro_error_string" in text, name
        if name == "flash_attention_bwd":
            assert "Replaces: no Pallas kernel." in text, name
        else:
            assert "Replaces: src/repro/kernels/" in text, name
    assert {k.split(".")[0] for k in runtime.LAUNCHES} == set(runtime.SOURCES)
    assert "mamba_scan.forward" in runtime.LAUNCHES
