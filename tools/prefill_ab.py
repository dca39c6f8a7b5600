#!/usr/bin/env python3
"""Prefill time of the port's danube and falcon-mamba at full width and
depth (batch 2 x 8192 tokens, the DaeMon bf16 working copy of a seed-0
master, as ``launch/serve.serve`` builds it), for the port found in one
source tree, so that two revisions can be timed in one call:

    python3 tools/prefill_ab.py [--tree DIR] [--reps 5]

``--tree`` is the root of a checkout (default: this one); its ``src`` is put
first on the path and its kernels are built under it.  Prints one JSON line:
per arch, the CUDA-event median and the runs of ``make_prefill_step``'s call
after two warm-up calls, with the card's name and power limit.  Run two
trees in turns (A, B, B, A) to compare them within one call.
Needs the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ARCHS = ("h2o-danube-1.8b", "falcon-mamba-7b")
BATCH, PROMPT, SEED = 2, 8192, 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    tree = a.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    assert Path(repro_torch.__file__).resolve().is_relative_to(tree), repro_torch.__file__
    dev = torch.device("cuda")
    out = {"tree": str(tree), "batch": BATCH, "prompt": PROMPT}
    for arch in ARCHS:
        cfg = get_config(arch)
        master = nn.init_params(M.model_specs(cfg), torch.Generator(device=dev).manual_seed(SEED),
                                dev)
        params = mv.working_copy(master, mv.DAEMON_DEFAULT)
        del master
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(SEED))
        prefill = steps.make_prefill_step(cfg)
        with torch.no_grad():
            for _ in range(2):
                prefill(params, {"tokens": tokens})
            runs = []
            for _ in range(a.reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                prefill(params, {"tokens": tokens})
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end))
        out[arch] = {"prefill_ms": statistics.median(runs), "runs_ms": runs}
        del params, tokens
        torch.cuda.empty_cache()
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
