"""The port's simulator on the Hopper kernels' own streams, on the CPU: the
capture catalog it registers (lazily: importing it captures nothing), and
traces crossing between the two packages' simulators as ``.npz`` files with
equal ``Metrics`` both ways, no tolerance."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core.sim as J
import repro_torch.core.sim as P
from repro_torch.capture import save_kernel_trace

ROOT = Path(__file__).resolve().parents[1]
HOPPER = ("fa_prefill_h100", "fa_decode_h100", "mamba_fwd_h100", "bq_quant_h100")
N = 2000


def canon(m) -> str:
    """Every field of a ``Metrics`` but the workload's name, floats to the
    last bit."""
    return repr({**dataclasses.asdict(m), "workload": None})


def test_the_port_registers_the_hopper_streams_and_no_pallas_one():
    names = P.available_workloads()
    assert names[-4:] == HOPPER
    for pallas in ("fa_prefill", "fa_decode", "mamba_fwd", "bq_quant"):
        assert pallas not in names and pallas in J.available_workloads()


def test_importing_the_simulator_captures_nothing():
    code = (
        "import sys\n"
        "import repro_torch.core.sim as S\n"
        "from repro_torch.capture import workloads as W\n"
        "assert set(W.CAPTURED) <= set(S.available_workloads())\n"
        "assert not W._RESULTS, sorted(W._RESULTS)\n"
        "kernels = sorted(m for m in sys.modules if m.startswith('repro_torch.kernels'))\n"
        "assert not kernels, kernels\n"
        "assert 'torch' not in sys.modules\n"
        "S.generate('bq_quant_h100', n=8)\n"
        "assert sorted(W._RESULTS) == ['bq_quant_h100']\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("scheme", ["page", "daemon"])
def test_a_hopper_trace_replays_equal_in_both_simulators(tmp_path, scheme):
    path = str(tmp_path / f"fa_decode_h100_{scheme}.npz")
    save_kernel_trace("fa_decode_h100", path)
    cfg = dict(link_bw_frac=0.125)
    registered = P.run_one("fa_decode_h100", scheme, P.SimConfig(**cfg), n_accesses=N)
    jax_file = J.run_one(J.register_trace_file(path).name, scheme, J.SimConfig(**cfg),
                         n_accesses=N)
    port_file = P.run_one(P.register_trace_file(path).name, scheme, P.SimConfig(**cfg),
                          n_accesses=N)
    assert canon(registered) == canon(jax_file) == canon(port_file)
    assert registered.cycles > 0


@pytest.mark.parametrize("scheme", ["page", "daemon"])
def test_a_jax_trace_file_replays_equal_in_the_port(tmp_path, scheme):
    from repro.capture import save_kernel_trace as save_pallas_trace

    path = str(tmp_path / f"mamba_fwd_{scheme}.npz")
    save_pallas_trace("mamba_fwd", path)  # through JAX's save_trace
    synthetic = str(tmp_path / f"ph_{scheme}.npz")
    J.save_trace(synthetic, J.generate("ph", seed=5, n=3000), compressibility=2.8)
    for trace in (path, synthetic):
        m_j = J.run_one(trace, scheme, J.SimConfig(link_bw_frac=0.25), n_accesses=N)
        m_p = P.run_one(trace, scheme, P.SimConfig(link_bw_frac=0.25), n_accesses=N)
        assert canon(m_p) == canon(m_j)


def test_fig8_on_the_mamba_stream_matches_jax_on_its_file(tmp_path):
    """fig8's daemon-over-page geomean on ``mamba_fwd_h100`` at the capture
    tool's size (20000 accesses a cell): the port's registered stream and
    JAX's simulator on the stream's ``.npz`` give the same float."""
    path = str(tmp_path / "mamba_fwd_h100.npz")
    save_kernel_trace("mamba_fwd_h100", path)
    kw = dict(schemes=("page", "daemon"), n_accesses=20_000)
    port = P.fig8_kernels(workloads=("mamba_fwd_h100",), **kw)
    jax = J.fig8_kernels(workloads=(J.register_trace_file(path).name,), **kw)
    assert len(port) == len(jax) == 4
    for rp, rj in zip(port, jax):
        assert {**rp, "workload": None} == {**rj, "workload": None}
    geomean = port[-1]
    assert geomean["bw_frac"] == "geomean"
    assert round(geomean["speedup_vs_page"], 3) == 1.296
