"""Quickstart, the PyTorch port's twin of ``examples/quickstart.py``:

1. The DaeMon reproduction: simulate the paper's data-movement schemes on a
   disaggregated system (``repro_torch.core.sim``, host code) and print
   Fig-2-style slowdowns.
2. Train a small LM with the DaeMon movement engine (page-class parameter
   movement + compressed grad path) through ``repro_torch.launch.train``.

    PYTHONPATH=src python examples/quickstart_torch.py                 # training on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def simulate():
    from repro_torch.core.sim import SimConfig, run_one

    print("=== DaeMon DS simulation (paper Fig. 2 slice) ===")
    cfg = SimConfig(link_bw_frac=0.25)
    for w in ("pr", "st"):
        loc = run_one(w, "local", cfg, n_accesses=8000)
        rows = {s: run_one(w, s, cfg, n_accesses=8000) for s in ("page", "cacheline", "daemon")}
        line = " ".join(f"{s}={m.cycles/loc.cycles:6.2f}x" for s, m in rows.items())
        print(f"  {w}: slowdown vs monolithic: {line}")
        print(f"      daemon speedup over page: {rows['page'].cycles/rows['daemon'].cycles:.2f}x")


def train_tiny(device):
    from repro_torch.launch.train import train

    print("=== tiny LM training with the daemon movement engine ===")
    _, _, losses = train(
        "minicpm-2b", reduced=True, steps=10, global_batch=4, seq_len=64,
        movement="daemon", log_every=5, device=device,
    )
    print(f"  loss: {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the training half's device (default: cuda)")
    args = ap.parse_args()
    simulate()
    train_tiny(args.device)
