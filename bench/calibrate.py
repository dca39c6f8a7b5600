"""Readings that a cell's limits are set from: the port's numbers on many
seeds, and the control's and the planted faults' on a few, in one process.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 8 [--out FILE]

Per seed, one JSON line: the numbers the cell compares for the port (set-up
and a short window at the cell's own load, then the check, as a run makes
them) and, on a control seed, for the control and the faults:

* control: the reference itself in the port's place, computed with every
  weight product's operands rounded to float8 e4m3 (the precision below the
  bfloat16 the configurations state).  A served cell reads, at every served
  position, the reference's gap of the token the control puts first.
* a training cell's half batch: the reference on half of each batch, the
  mean taken over the rest;
* a served cell's altered token: each served token moved to the next id
  where it is produced.

A step that returns its state unchanged reads 1 on ``change_norm_gap`` by
the measure's definition and needs no run.  The benchmark's own runs run
none of this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    import torch

    from bench.harness import common
    from bench.harness.driver import kind_module
    from bench.harness.trace import Tracer
    from bench.harness.weights import draw_weights

    mod = kind_module(cell.traffic["kind"])
    kind = mod.Kind(cell.cfg, cell.traffic, seed, device)
    t0 = time.perf_counter()
    kind.setup()
    kind.window(seconds, Tracer(False, 0, 0, device))
    kind.release()
    out = {"seed": seed, "program": kind.check(), "attempted": kind.attempted}
    if not control:
        out["s"] = time.perf_counter() - t0
        return out
    if cell.traffic["kind"] == "train":
        out["control"] = mod.numbers(kind.reference("fp8"), kind.ref)
        out["half_batch"] = mod.numbers(kind.reference("f32", half_batch=True), kind.ref)
    else:
        weights = draw_weights(cell.cfg, seed, device)
        ctrl = kind.reference_logits(weights, "fp8")
        del weights
        common.free(device)
        ref, v = kind.ref, cell.cfg["vocab_size"]
        out["control"] = {"served_token_gap": float(torch.cat(
            [common.served_gaps(ref[k], ctrl[k].argmax(-1)) for k in ref]).max())}
        out["altered_token"] = {"served_token_gap": float(torch.cat(
            [common.served_gaps(ref[k], (kind.served(k).long() + 1) % v) for k in ref]).max())}
    out["s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import cells

    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA card here", file=sys.stderr)
        return 2
    cell = cells.load(args.workload, ROOT)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            line = json.dumps({"workload": args.workload, "gpu": torch.cuda.get_device_name(device),
                               **readings(cell, seed, args.seconds, device, seed in controls)})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
