"""Training entry point (port of ``repro.launch.train``), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --batch 2 --seq 4096 --steps 3 --movement daemon
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --reduced \
        --steps 20 --batch 4 --seq 32 --movement daemon --device cpu --ckpt-dir /tmp/ck

Wires together: config -> data pipeline -> (baseline | daemon) train step ->
async checkpointing -> supervisor (heartbeat + straggler policy) ->
restart from the latest checkpoint.  Runs on the card unless ``--device cpu``
is given.  Checkpoints are in the JAX package's format, and a daemon run
(bf16 working copy) resumes.  Device meshes are not ported yet and raise
(ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import device as devices
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import movement as mv
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.models import nn
from repro_torch.optim import adamw
from repro_torch.runtime.fault import HeartbeatMonitor, RunSupervisor, StragglerPolicy


def train(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 128,
    movement: str = "baseline",
    peak_lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    resume: bool = False,
    mesh_shape=None,
    num_microbatches: int = 1,
    log_every: int = 10,
    seed: int = 0,
    device=None,
):
    """-> (params, state, losses), as JAX's ``train``."""
    dev = devices.resolve(device)
    if mesh_shape is not None and tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh {mesh_shape}: the port trains on one device until ROADMAP Queue 1 item 15 "
            "(sharding)"
        )
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    specs = M.model_specs(cfg)
    master = nn.init_params(specs, torch.Generator(device=dev).manual_seed(seed), dev)

    step_fn = steps_lib.make_train_step(
        cfg, peak_lr=peak_lr, total_steps=steps, movement=movement,
        num_microbatches=num_microbatches,
    )
    if movement == "daemon":
        state = mv.init_state(master)
        params = mv.working_copy(master, mv.DAEMON_DEFAULT)
    else:
        state = adamw.init(master)
        params = master

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and resume and mgr.latest_step() is not None:
        (params, state), extra = mgr.restore(None, (params, state))
        start_step = int(extra.get("step", 0))
        print(f"resumed from step {start_step}")

    pipe = TokenPipeline(
        DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
            seed=seed,
        ),
        start_step=start_step,
    )
    supervisor = RunSupervisor(
        hosts=[0],
        monitor=HeartbeatMonitor(interval_s=60),
        policy=StragglerPolicy(),
    )

    losses = []
    t_start = time.time()
    try:
        for i, host_batch in zip(range(start_step, steps), pipe):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in host_batch.items()}
            t0 = time.time()
            params, state, metrics = step_fn(params, state, batch)
            loss = float(metrics["loss"])  # waits for the step
            losses.append(loss)
            supervisor.monitor.beat(0)
            supervisor.tick({0: time.time() - t0})
            if mgr and (i + 1) % ckpt_every == 0:
                mgr.save_async(i + 1, (params, state), {"step": i + 1, "arch": arch})
            if (i + 1) % log_every == 0 or i == start_step:
                print(
                    f"step {i+1:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"({(time.time()-t_start)/(i-start_step+1):.2f}s/step)"
                )
    finally:
        pipe.close()
        if mgr:  # the last save lands even if a step raised
            mgr.wait()
    return params, state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--movement", default="baseline", choices=["baseline", "daemon"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args()
    _, _, losses = train(
        a.arch, reduced=a.reduced, steps=a.steps, global_batch=a.batch,
        seq_len=a.seq, movement=a.movement, peak_lr=a.lr,
        ckpt_dir=a.ckpt_dir or None, resume=a.resume,
        num_microbatches=a.microbatches, device=a.device,
    )
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
