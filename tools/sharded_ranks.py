#!/usr/bin/env python3
"""h2o-danube-1.8b trained and served sharded over a mesh of ranks, one
process a card, against the same runs on one card.

    python3 tools/sharded_ranks.py                          # 4 ranks, 4 cards, NCCL
    python3 tools/sharded_ranks.py --device cpu --reduced   # 4 gloo ranks, CPU

Checks, in order (rank 0 prints one JSON line each):
  * ``step``: the DaeMon step (``make_train_step(movement="daemon")``,
    DAEMON_AGGRESSIVE) from the seeded master, ``--steps`` steps of
    ``--batch`` x ``--seq`` from the token pipeline, on each mesh of
    ``--meshes`` (data x model) against the same steps on one card (rank 0
    alone; ``--ref-microbatches`` splits its batch, so that B = 4 x 4096 fits
    one card): the losses within LOSS_RTOL, ``step_s`` (median of the steps
    after the first), per-card peak memory, the bytes of master, m, v and
    residual each rank holds against the whole, and K1/K2/K3 launches a step
    on each rank (K1 = K2 = 18, one per foldable gradient and page-class
    weight; K3 none);
  * ``serve``: ``serve`` of each arch in ``--serve-archs`` on each mesh of
    ``--serve-meshes`` against one card: the prefill's last logits within
    LOGIT_TOL, the first token equal wherever one card's top two logits are
    more than 2 x LOGIT_TOL apart, ``prefill_s``, ``decode_s_per_token``,
    peak memory and K3/K4 launches on each rank;
  * ``grads`` (``--grads-meshes``): the gradients of the loss at the
    seeded bf16 working copy on the first batch, on each mesh against one
    device: every leaf within GRAD_TOL of its largest one-device magnitude
    (bf16 gradients summed in another order);
  * ``driver`` (``--driver-meshes``): the ``train`` entry point (baseline
    movement; ``--init-npz`` gives its initial master, JAX's keys joined by
    "/") on each mesh against one device;
  * ``fold`` (``--fold-mesh``): the DAEMON_AGGRESSIVE fold of seeded
    gradients and the working copy of the seeded master on the mesh, against
    one device: residual, arrived gradients and working copy bit for bit;
  * ``resume`` (``--resume SAVE:RESUME``, a ``--ckpt-dir`` needed): ``train``
    with movement="daemon" on mesh SAVE, checkpointed at step 2 of 4; then
    resumed from that step on mesh RESUME: steps 3-4 within LOSS_RTOL of the
    uninterrupted run's.
Every rank checks its own numbers too.  Exits 1 if a check fails or a rank
does not finish.  Needs ``--ranks`` cards (or ``--device cpu``) and the rest
of the repository beside it.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import multiprocessing as mp
import os
import shutil
import statistics
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ARCH, SEED = "h2o-danube-1.8b", 0
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's loss tolerance
LOGIT_TOL = 8e-2  # tests/test_torch_serve.py's logit tolerance
GRAD_TOL = 5e-2  # of a leaf's largest one-device magnitude: bf16 gradients
KERNELS = ("block_quant.quantize", "block_quant.dequantize", "flash_attention.forward",
           "mamba_scan.forward")


def parse_meshes(spec: str):
    return [tuple(int(x) for x in m.split("x")) for m in spec.split(",") if m]


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(torch, dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def _reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def run_steps(torch, cfg, mesh, a, dev, microbatches: int) -> dict:
    """``a.steps`` DAEMON_AGGRESSIVE steps from the seeded master, on ``mesh``
    (None: this device alone)."""
    from repro_torch.core import movement as mv
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn
    from repro_torch.runtime import sharding as shd

    rules = None
    if mesh is not None:
        rules = shd.base_rules(mesh, fsdp=True)
        shd.activate(mesh, rules)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=a.seq,
                                    global_batch=a.batch, seed=SEED))
    try:
        specs = M.model_specs(cfg)
        master = nn.init_params(specs, torch.Generator(device=dev).manual_seed(SEED), dev)
        if mesh is not None:
            master = shd.place_tree(master, shd.sharding_for_specs(mesh, rules, specs))
        state = mv.init_state(master)
        params = mv.working_copy(master, mv.DAEMON_AGGRESSIVE)
        del master
        step = steps.make_train_step(cfg, total_steps=a.steps, movement="daemon",
                                     movement_cfg=mv.DAEMON_AGGRESSIVE,
                                     num_microbatches=microbatches)
        losses, times, launches = [], [], []
        _reset_peak(torch, dev)
        for _ in range(a.steps):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in next(pipe).items()}
            batch.update(M.stub_inputs(cfg, batch["tokens"]))
            if mesh is not None:
                batch = shd.place_tree(batch, shd.batch_sharding(mesh, rules, batch))
            runtime.reset_launches()
            _sync(torch, dev)
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
            launches.append({k: runtime.LAUNCHES[k] for k in KERNELS[:3]})

        def local_bytes(tree):
            return sum((x.to_local() if nn.is_dtensor(x) else x).numel() * 4
                       for x in nn.tree_leaves(tree))

        def whole_bytes(tree):
            return sum(math.prod(x.shape) * 4 for x in nn.tree_leaves(tree))

        parts = {"master": state.master, "m": state.adam.m, "v": state.adam.v,
                 "residual": state.residual}
        out = {"losses": losses, "step_s_each": times,
               "step_s": statistics.median(times[1:]) if len(times) > 1 else times[0],
               "peak_memory_gb": _peak_gb(torch, dev), "launches_per_step": launches,
               "state_bytes": {k: local_bytes(t) for k, t in parts.items()},
               "state_bytes_whole": {k: whole_bytes(t) for k, t in parts.items()}}
        if mesh is not None:  # what an even split of every sharded leaf leaves a rank
            out["state_bytes_even"] = {
                k: sum(math.prod(x.shape) * 4 // _split(x) for x in nn.tree_leaves(t))
                for k, t in parts.items()}
        del params, state
        return out
    finally:
        pipe.close()
        if mesh is not None:
            shd.deactivate()


def _split(x) -> int:
    """How many blocks the mesh cuts the DTensor ``x`` into."""
    from torch.distributed.tensor import Shard

    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n *= x.device_mesh.size(i)
    return n


def run_serve(torch, cfg, shape, a, dev) -> dict:
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve_config

    _reset_peak(torch, dev)
    runtime.reset_launches()
    r = serve_config(cfg, batch=a.serve_batch, prompt_len=a.prompt_len,
                     gen_tokens=a.gen_tokens, movement="daemon", mesh_shape=shape, seed=SEED,
                     device=dev, return_logits=True)
    return {"logits": r["logits"], "tokens": r["tokens"].tolist(),
            "prefill_s": r["prefill_s"], "decode_s_per_token": r["decode_s_per_token"],
            "peak_memory_gb": _peak_gb(torch, dev),
            "launches": {k: runtime.LAUNCHES[k] for k in KERNELS}}


def _rel(xs, ys) -> float:
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(xs, ys))


def load_init(path: str, torch, dev):
    import numpy as np

    from repro_torch.convert import params_from_numpy

    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, last = key.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = z[key]
    return params_from_numpy(tree, dev, torch.float32)


def worker(rank: int, n: int, a, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh

    # DTensor warns on every multi-dim redistribution; the checks speak for it
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    cuda = a.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("cpu:gloo,cuda:nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank, world_size=n,
                            timeout=timedelta(seconds=a.timeout))
    lines, ok = [], True

    def emit(check, good, **fields):
        nonlocal ok
        ok = ok and bool(good)
        line = {"check": check, "ok": bool(good), **fields}
        lines.append(line)
        if rank == 0:
            print(json.dumps(line), flush=True)

    def gather(obj):
        """Every rank's ``obj``, on every rank."""
        out = [None] * n
        dist.all_gather_object(out, obj)
        return out

    try:
        cfg = get_config(ARCH)
        cfg = cfg.reduced() if a.reduced else cfg
        meshes = parse_meshes(a.meshes)
        if meshes:
            ref = run_steps(torch, cfg, None, a, dev, a.ref_microbatches) if rank == 0 else None
            ref = gather(ref)[0]
            if cuda:
                torch.cuda.empty_cache()
        for shape in meshes:
            got = run_steps(torch, cfg, make_mesh(shape, device=dev), a, dev, 1)
            # the plain versions run on the CPU, and count no launch
            want = {"block_quant.quantize": 18, "block_quant.dequantize": 18,
                    "flash_attention.forward": 0} if cuda else dict.fromkeys(KERNELS[:3], 0)
            mine = all(l == want for l in got["launches_per_step"])
            mine = mine and got["state_bytes"] == got["state_bytes_even"]
            everyone = gather({"ok": mine, "peak_memory_gb": got["peak_memory_gb"],
                               "state_bytes": got["state_bytes"],
                               "launches_per_step": got["launches_per_step"]})
            rel = _rel(got["losses"], ref["losses"])
            whole = sum(got["state_bytes_whole"].values())
            emit("step", rel <= LOSS_RTOL and all(e["ok"] for e in everyone),
                 mesh=list(shape), arch=cfg.name, batch=a.batch, seq=a.seq, steps=a.steps,
                 movement="daemon (DAEMON_AGGRESSIVE)", losses=got["losses"],
                 one_card_losses=ref["losses"], loss_max_rel=rel, loss_rtol=LOSS_RTOL,
                 one_card_microbatches=a.ref_microbatches,
                 step_s=got["step_s"], step_s_each=got["step_s_each"],
                 one_card_step_s=ref["step_s"], peak_memory_gb_per_rank=[
                     e["peak_memory_gb"] for e in everyone],
                 one_card_peak_memory_gb=ref["peak_memory_gb"],
                 state_bytes_per_rank=[sum(e["state_bytes"].values()) for e in everyone],
                 state_bytes_even_split=sum(got["state_bytes_even"].values()),
                 state_bytes_whole=whole, state_bytes_whole_by_part=got["state_bytes_whole"],
                 state_share_per_rank=[sum(e["state_bytes"].values()) / whole for e in everyone],
                 launches_per_step_rank0=got["launches_per_step"],
                 launches_ok_per_rank=[e["ok"] for e in everyone])
            if cuda:
                torch.cuda.empty_cache()

        for arch in [x for x in a.serve_archs.split(",") if x]:
            scfg = get_config(arch)
            scfg = scfg.reduced() if a.reduced else scfg
            for shape in parse_meshes(a.serve_meshes):
                ref = run_serve(torch, scfg, None, a, dev) if rank == 0 else None
                ref = gather(ref)[0]
                got = run_serve(torch, scfg, shape, a, dev)
                everyone = gather({"peak_memory_gb": got["peak_memory_gb"],
                                   "launches": got["launches"]})
                err = float((got["logits"] - ref["logits"]).abs().max())
                # the first token is the prefill logits' argmax: it must agree
                # wherever one card's top two are further apart than the two
                # runs' logits may be; later tokens follow the first
                # difference, and random weights at full width leave near ties
                top2 = ref["logits"].topk(2, dim=-1).values
                clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
                first = [g[0] == r[0] for g, r in zip(got["tokens"], ref["tokens"])]
                first_ok = all(f or not c for f, c in zip(first, clear.tolist()))
                want_k3 = scfg.num_layers if scfg.family == "dense" else 0
                want_k4 = scfg.num_layers if scfg.family == "ssm" else 0
                if not cuda:  # the plain versions count no launch
                    want_k3 = want_k4 = 0
                launched = all(e["launches"]["flash_attention.forward"] == want_k3 and
                               e["launches"]["mamba_scan.forward"] == want_k4
                               for e in everyone)
                emit("serve", err <= LOGIT_TOL and launched and first_ok,
                     mesh=list(shape), arch=scfg.name, batch=a.serve_batch,
                     prompt_len=a.prompt_len, gen_tokens=a.gen_tokens,
                     logits_max_abs_err=err, logit_tol=LOGIT_TOL,
                     tokens_equal=got["tokens"] == ref["tokens"],
                     first_token_equal=first, first_token_margin_clear=clear.tolist(),
                     prefill_s=got["prefill_s"], one_card_prefill_s=ref["prefill_s"],
                     decode_s_per_token=got["decode_s_per_token"],
                     one_card_decode_s_per_token=ref["decode_s_per_token"],
                     peak_memory_gb_per_rank=[e["peak_memory_gb"] for e in everyone],
                     one_card_peak_memory_gb=ref["peak_memory_gb"],
                     launches_per_rank=[e["launches"] for e in everyone],
                     one_card_launches=ref["launches"])

        if a.grads_meshes:
            run_grads(torch, cfg, a, dev, rank, emit)
        if a.driver_meshes:
            run_driver(torch, a, dev, rank, gather, emit)
        if a.fold_mesh:
            run_fold(torch, cfg, parse_meshes(a.fold_mesh)[0], dev, gather, emit)
        if a.resume:
            run_resume(torch, a, dev, rank, gather, emit)
    except BaseException as e:
        ok = False
        print(f"sharded_ranks rank {rank}: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        raise
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps({"ok": ok, "lines": len(lines)}))
        dist.destroy_process_group()


def _train(arch, shape, a, dev, **kw):
    import contextlib
    import io

    from repro_torch.launch.train import train

    with contextlib.redirect_stdout(io.StringIO()):
        _, _, losses = train(arch, reduced=a.reduced, global_batch=a.batch, seq_len=a.seq,
                             mesh_shape=shape, device=dev, log_every=10**9, **kw)
    return losses


def run_driver(torch, a, dev, rank, gather, emit) -> None:
    init = load_init(a.init_npz, torch, dev) if a.init_npz else None
    ref = _train(ARCH, None, a, dev, steps=a.steps, init=init) if rank == 0 else None
    ref = gather(ref)[0]
    for shape in parse_meshes(a.driver_meshes):
        losses = _train(ARCH, shape, a, dev, steps=a.steps, init=init)
        rel = _rel(losses, ref)
        emit("driver", rel <= LOSS_RTOL, mesh=list(shape), losses=losses,
             one_device_losses=ref, loss_max_rel=rel, init="npz" if init else "seed")


def run_grads(torch, cfg, a, dev, rank, emit) -> None:
    from repro_torch.core import movement as mv
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import nn
    from repro_torch.runtime import sharding as shd

    specs = M.model_specs(cfg)
    params = mv.working_copy(
        nn.init_params(specs, torch.Generator(device=dev).manual_seed(SEED), dev),
        mv.DAEMON_DEFAULT)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=a.seq,
                                    global_batch=a.batch, seed=SEED))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(pipe).items()}
    pipe.close()
    want = None
    if rank == 0:
        g, m = steps._value_and_grad(cfg, params, batch)
        want = ([x.float().cpu() for x in nn.tree_leaves(g)], float(m["loss"]))
        del g
    for shape in parse_meshes(a.grads_meshes):
        mesh = make_mesh(shape, device=dev)
        rules = shd.base_rules(mesh, fsdp=True)
        shd.activate(mesh, rules)
        try:
            dp = shd.place_tree(params, shd.sharding_for_specs(mesh, rules, specs))
            db = shd.place_tree(batch, shd.batch_sharding(mesh, rules, batch))
            g, m = steps._value_and_grad(cfg, dp, db)
            got = [shd.to_global(x).float().cpu() for x in nn.tree_leaves(g)]
            del g, dp
        finally:
            shd.deactivate()
        if rank == 0:
            rel = {path: float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for path, x, y in zip(_paths(specs), got, want[0])}
            worst = max(rel, key=rel.get)
            emit("grads", rel[worst] <= GRAD_TOL, mesh=list(shape), loss=float(m["loss"]),
                 one_device_loss=want[1], worst_leaf=worst, worst_rel=rel[worst],
                 grad_tol=GRAD_TOL, rel_by_leaf=rel)
        else:
            emit("grads", True, mesh=list(shape))


def run_fold(torch, cfg, shape, dev, gather, emit) -> None:
    """The fold of seeded bf16 gradients into a zero residual, then of the
    same gradients into that residual, and the working copy, on the mesh and
    on one device: bit for bit."""
    from repro_torch.core import movement as mv
    from repro_torch.core.movement import daemon_step as ds
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import nn
    from repro_torch.runtime import sharding as shd

    specs = M.model_specs(cfg)
    master = nn.init_params(specs, torch.Generator(device=dev).manual_seed(SEED), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    grads = nn.tree_map(lambda p: (torch.randn(p.shape, generator=gen, device=dev) * 1e-2)
                        .to(torch.bfloat16), master)

    def run(master, grads, residual):
        arrived = {str(i): nn.tree_map(ds.fold, grads, residual) for i in range(2)}
        return arrived, residual, mv.working_copy(master, mv.DAEMON_AGGRESSIVE)

    with torch.no_grad():
        want = run(master, grads, nn.tree_map(torch.zeros_like, master))
        mesh = make_mesh(shape, device=dev)
        rules = shd.base_rules(mesh, fsdp=True)
        shd.activate(mesh, rules)
        try:
            psh = shd.sharding_for_specs(mesh, rules, specs)
            place = lambda t: shd.place_tree(t, psh)  # noqa: E731
            got = run(place(master), place(grads), place(nn.tree_map(torch.zeros_like, master)))
            layouts = {}
            for path, x in zip(_paths(specs), nn.tree_leaves(place(master))):
                if ds.is_foldable(tuple(x.shape)):
                    layouts[path] = [str(x.placements), str(ds.block_layout(x))]
        finally:
            shd.deactivate()
    diffs = []
    for name, w, g in [("arrived", want[0], got[0]), ("residual", want[1], got[1]),
                       ("working_copy", want[2], got[2])]:
        for path, x, y in zip(_paths(w), nn.tree_leaves(w), nn.tree_leaves(g)):
            if not torch.equal(x, shd.to_global(y)):
                diffs.append(f"{name}:{path}")
    every = gather(diffs)
    emit("fold", not any(every), mesh=list(shape), foldable_layouts=layouts,
         differing_leaves=every)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def run_resume(torch, a, dev, rank, gather, emit) -> None:
    import torch.distributed as dist

    save, resume = parse_meshes(a.resume.replace(":", ","))
    ckpt = Path(a.ckpt_dir)
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    dist.barrier()
    full = _train(ARCH, save, a, dev, steps=4, movement="daemon", ckpt_dir=str(ckpt),
                  ckpt_every=2)
    if rank == 0:  # keep step 2 only: the resumed run starts there
        shutil.rmtree(ckpt / "step_00000004")
    dist.barrier()
    resumed = _train(ARCH, resume, a, dev, steps=4, movement="daemon", ckpt_dir=str(ckpt),
                     resume=True)
    rel = _rel(resumed, full[2:])
    emit("resume", len(resumed) == 2 and rel <= LOSS_RTOL, saved_on=list(save),
         resumed_on=list(resume), uninterrupted_losses=full, resumed_losses=resumed,
         loss_max_rel=rel, ckpt_dir=str(ckpt))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reduced", action="store_true", help="reduced danube (and serve archs)")
    ap.add_argument("--meshes", default="4x1,2x2,1x4", help="DaeMon-step meshes, data x model")
    ap.add_argument("--serve-meshes", default="1x4")
    ap.add_argument("--serve-archs", default=ARCH)
    ap.add_argument("--driver-meshes", default="", help="train() entry-point meshes")
    ap.add_argument("--init-npz", default="", help="initial master for --driver-meshes")
    ap.add_argument("--grads-meshes", default="4x1,2x2,1x4")
    ap.add_argument("--fold-mesh", default="")
    ap.add_argument("--resume", default="", help="SAVE:RESUME meshes, e.g. 2x1:1x2")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None, help="default 4 (x 4096; reduced x 32)")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ref-microbatches", type=int, default=None,
                    help="the one-card step's microbatches (default 2 on the card at full size)")
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds for every rank")
    a = ap.parse_args()
    a.batch = a.batch or 4
    a.seq = a.seq or (32 if a.reduced else 4096)
    full_card = a.device == "cuda" and not a.reduced
    if a.ref_microbatches is None:
        a.ref_microbatches = 2 if full_card else 1
    a.serve_batch, a.prompt_len, a.gen_tokens = (2, 8192, 16) if not a.reduced else (2, 32, 4)
    if a.resume and not a.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")

    import torch

    if a.device == "cuda" and torch.cuda.device_count() < a.ranks:
        print(f"sharded_ranks: {torch.cuda.device_count()} cards, not {a.ranks}",
              file=sys.stderr)
        return 1
    build_s = None
    if a.device == "cuda":  # once, before the ranks: none of their timings holds nvcc
        from repro_torch.kernels import runtime

        t0 = time.perf_counter()
        runtime.build()
        build_s = time.perf_counter() - t0
    out_dir = ROOT / "build" / f"sharded_ranks.{os.getpid()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, a.ranks, a, str(store), str(out_dir)))
             for r in range(a.ranks)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + a.timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    results = [json.loads((out_dir / f"rank{r}.json").read_text())
               for r in range(a.ranks) if (out_dir / f"rank{r}.json").exists()]
    good = codes == [0] * a.ranks and len(results) == a.ranks and all(r["ok"] for r in results)
    line = {"tool": "sharded_ranks", "device": a.device, "ranks": a.ranks,
            "reduced": a.reduced, "exit_codes": codes, "wall_s": time.perf_counter() - t0,
            "build_s": build_s, "ok": good}
    if a.device == "cuda":
        from chip_smoke import nvidia_smi

        line["nvidia_smi"] = nvidia_smi()
    print(json.dumps(line), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
