#!/usr/bin/env python3
"""How deep minicpm-2b's DaeMon training step fits one CUDA card.

    python3 tools/tied_depth.py 38 40

For each depth given (layers of minicpm-2b at full width), runs
``chip_smoke.py``'s ``train_tied`` phase (``run_train_step``: batch 2 x 4096,
DAEMON_AGGRESSIVE, 4 timed steps and one profiled, every check) in a child
process of its own, so that one depth's out-of-memory leaves the next a
clean card, and prints one JSON line a depth: its peak device memory and
step_s, or the error that ended it.  ``chip_smoke.TIED_TRAIN_LAYERS`` is the
deepest that fits.  Needs the card, nvcc and the rest of the repository
beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import dataclasses, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import runtime

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
runtime.build()
cfg = dataclasses.replace(get_config(cs.TIED_ARCH), num_layers=int(sys.argv[1]))
pages, fold_only = cs.page_class_shapes(cfg), cs.fold_only_shapes(cfg)
cs.run_train_step(torch, runtime, cfg, "train_tied", (len(pages) + len(fold_only), len(pages)))
print(json.dumps({"layers": cfg.num_layers, **{k: cs.UNSHARDED["train_tied"][k]
                                               for k in ("step_s", "peak_memory_gb")}}))
"""


def main() -> int:
    depths = [int(a) for a in sys.argv[1:]] or [40]
    for layers in depths:
        run = subprocess.run([sys.executable, "-c", _CHILD, str(layers)], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith('{"layers"')]
        if run.returncode == 0 and lines:
            print(json.dumps({"fits": True, **json.loads(lines[-1])}), flush=True)
        else:
            err = (run.stderr.strip().splitlines() or ["no output"])[-1]
            print(json.dumps({"layers": layers, "fits": False, "rc": run.returncode,
                              "error": err[:400]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
