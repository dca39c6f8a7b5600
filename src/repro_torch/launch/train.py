"""Training entry point (port of ``repro.launch.train``), on one device or
sharded over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --batch 2 --seq 4096 --steps 3 --movement daemon
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --batch 2 --seq 4096 --steps 3 --movement daemon
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --batch 16 --seq 1024 --steps 3 --movement daemon
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --reduced \
        --steps 20 --batch 4 --seq 32 --movement daemon --device cpu --ckpt-dir /tmp/ck

Every family trains: dense, MoE (deepseek-v2-lite with MLA, dbrx), SSM
(falcon-mamba: the chunked scan, never kernel K4), hybrid (zamba2), VLM
(internvl2: zero patch embeddings in front of each batch) and enc-dec
(whisper: zero frames of ``seq_len``), as JAX's driver feeds them.

Wires together: config -> mesh/shardings -> data pipeline -> (baseline |
daemon) train step -> async checkpointing -> supervisor (heartbeat +
straggler policy) -> restart from the latest checkpoint.  Runs on the card
unless ``--device cpu`` is given.  Checkpoints are in the JAX package's
format, and a daemon run (bf16 working copy) resumes.

``mesh_shape=None`` trains on one device.  A shape, such as ``(2, 2)`` for
(data, model), shards the run over an initialised process group of that
many ranks, one a device (``launch.mesh.make_mesh`` raises without one):
parameters, master, moments and residual are DTensors laid out by
``runtime.sharding.base_rules(mesh, fsdp=True)``, and every rank draws the
same global batch from the pipeline and keeps its rows.  Launch one process
a rank with ``torch.distributed`` initialised, as ``tools/sharded_ranks.py``
does.
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
from repro_torch.launch.mesh import make_mesh, parse_shape
from repro_torch.models import model as M
from repro_torch.models import nn
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd
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
    init=None,
):
    """-> (params, state, losses), as JAX's ``train``.  On a mesh the
    returned trees hold DTensors and the losses are global.  ``init``, if
    given, is the initial master: a tree of global tensors with the specs'
    keys and shapes (for example JAX-initialised weights through
    ``repro_torch.convert``), in place of the draw from ``seed``."""
    dev = devices.resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    mesh = rules = None
    if mesh_shape is not None:
        mesh = make_mesh(tuple(mesh_shape), device=dev)
        rules = shd.base_rules(mesh, fsdp=True)
        shd.activate(mesh, rules)
    try:
        return _train(cfg, arch, mesh, rules, steps=steps, global_batch=global_batch,
                      seq_len=seq_len, movement=movement, peak_lr=peak_lr,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=resume,
                      num_microbatches=num_microbatches, log_every=log_every, seed=seed,
                      dev=dev, init=init)
    finally:
        if mesh is not None:
            shd.deactivate()


def _train(cfg, arch, mesh, rules, *, steps, global_batch, seq_len, movement, peak_lr, ckpt_dir,
           ckpt_every, resume, num_microbatches, log_every, seed, dev, init):
    specs = M.model_specs(cfg)
    if init is None:
        master = nn.init_params(specs, torch.Generator(device=dev).manual_seed(seed), dev)
    else:
        master = nn.tree_map(lambda x: x.to(device=dev, dtype=torch.float32, copy=True), init)
    psh = None
    if mesh is not None:
        psh = shd.sharding_for_specs(mesh, rules, specs)
        master = shd.place_tree(master, psh)

    step_fn = steps_lib.make_train_step(
        cfg, peak_lr=peak_lr, total_steps=steps, movement=movement,
        num_microbatches=num_microbatches,
    )
    if movement == "daemon":
        state = mv.init_state(master)
        params = mv.working_copy(master, mv.DAEMON_DEFAULT)
        ssh = mv.state_shardings(psh)
    else:
        state = adamw.init(master)
        params = master
        ssh = adamw.AdamWState(None, psh, psh)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and resume and mgr.latest_step() is not None:
        shardings = None if mesh is None else (psh, ssh)
        (params, state), extra = mgr.restore(None, (params, state), shardings=shardings)
        start_step = int(extra.get("step", 0))
        print(f"resumed from step {start_step}")

    pipe = TokenPipeline(
        DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
            seed=seed,
        ),
        start_step=start_step,
    )
    n_hosts = 1 if mesh is None else mesh.size()
    supervisor = RunSupervisor(
        hosts=list(range(n_hosts)),
        monitor=HeartbeatMonitor(interval_s=60),
        policy=StragglerPolicy(),
    )

    losses = []
    t_start = time.time()
    try:
        for i, host_batch in zip(range(start_step, steps), pipe):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in host_batch.items()}
            batch.update(M.stub_inputs(cfg, batch["tokens"]))
            if mesh is not None:  # every rank drew the global batch: keep its rows
                batch = shd.place_tree(batch, shd.batch_sharding(mesh, rules, batch))
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
    ap.add_argument("--mesh", default="", help="e.g. 2x2 (data x model); needs torch.distributed")
    a = ap.parse_args()
    _, _, losses = train(
        a.arch, reduced=a.reduced, steps=a.steps, global_batch=a.batch,
        seq_len=a.seq, movement=a.movement, peak_lr=a.lr,
        ckpt_dir=a.ckpt_dir or None, resume=a.resume,
        num_microbatches=a.microbatches, device=a.device,
        mesh_shape=parse_shape(a.mesh) if a.mesh else None,
    )
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
