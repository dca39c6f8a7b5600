"""The PyTorch port's twin of ``examples/simulate_daemon.py``: reproduce the
paper's headline numbers (geomean daemon-vs-page speedup and access-cost
reduction across the workload suite and network range) on the port's
simulator, ``repro_torch.core.sim``.

    PYTHONPATH=src python examples/simulate_daemon_torch.py [--n-accesses 20000]

The simulator is host code: it runs on the CPU and needs no card.
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-accesses", type=int, default=20_000)
    args = ap.parse_args()

    from repro_torch.core.sim import paper_claims

    print("DaeMon vs page-granularity movement (paper claims: 2.39x perf, "
          "3.06x access cost)")
    r = paper_claims(n_accesses=args.n_accesses)
    for bw, row in r["per_bw"].items():
        per_w = " ".join(f"{w}:{v:.2f}" for w, v in row["per_workload"].items())
        print(f"  link bw = {bw:5.3f} x bus: perf {row['perf']:.2f}x  "
              f"cost {row['cost']:.2f}x   [{per_w}]")
    print(f"  GEOMEAN: perf {r['perf_speedup_geomean']:.2f}x  "
          f"access-cost {r['access_cost_reduction_geomean']:.2f}x")


if __name__ == "__main__":
    main()
