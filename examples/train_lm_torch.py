"""End-to-end example, the PyTorch port's twin of ``examples/train_lm.py``:
train a ~100M-parameter llama-like LM for a few hundred steps with
checkpointing, the WSD schedule and the DaeMon movement engine, through
``repro_torch.launch.train``.

    PYTHONPATH=src python examples/train_lm_torch.py --ckpt-dir ""   # ~100M, 300 steps, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --small --steps 30 --device cpu \\
        --ckpt-dir build/train_lm_torch
    PYTHONPATH=src python examples/train_lm_torch.py --small --steps 40 --device cpu \\
        --ckpt-dir build/train_lm_torch --resume                    # steps 31-40

Checkpoints are written every 100 steps, as in JAX's example, and at the last
step of a shorter run, so that a CI-sized run can be resumed.  They are
zstandard-compressed (the JAX package's format): on a machine without
``zstandard`` pass ``--ckpt-dir ""``.
"""
import argparse
import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402


def lm_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-100m",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32_000,
        attn_kind="full",
        schedule="wsd",
        attn_chunk=256,
    )


def lm_small() -> ModelConfig:
    return dataclasses.replace(
        lm_100m(), name="llama-8m", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=2, d_ff=688, vocab_size=4_096,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--movement", default="daemon", choices=["baseline", "daemon"])
    ap.add_argument("--ckpt-dir", default=os.path.join(REPO, "build", "train_lm_torch"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    cfg = lm_small() if args.small else lm_100m()

    # register the custom config then reuse the standard training entry point
    import repro_torch.configs as C
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    C.REGISTRY[cfg.name] = cfg
    print(f"training {cfg.name}: {M.param_count(cfg)/1e6:.1f}M params, "
          f"{args.steps} steps, movement={args.movement}")
    _, _, losses = T.train(
        cfg.name, reduced=False, steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, movement=args.movement, ckpt_dir=args.ckpt_dir or None,
        ckpt_every=min(100, args.steps), resume=args.resume, log_every=10,
        device=args.device,
    )
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    if args.steps >= 50 and not args.resume:  # shorter runs are still inside LR warmup
        assert losses[-1] < losses[0], "training did not reduce loss"


if __name__ == "__main__":
    main()
