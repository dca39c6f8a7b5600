#!/usr/bin/env python3
"""Every model family trained and served sharded over a mesh of ranks, one
process a card, against the same runs on one card.

    python3 tools/sharded_ranks.py                          # 4 ranks, 4 cards, NCCL
    python3 tools/sharded_ranks.py --device cpu --reduced   # 4 gloo ranks, CPU
    python3 tools/sharded_ranks.py --train-archs zamba2-1.2b,falcon-mamba-7b,\
        deepseek-v2-lite-16b,whisper-base --meshes 2x2 --grads-meshes 2x2 \
        --serve-archs falcon-mamba-7b,zamba2-1.2b,deepseek-v2-lite-16b,whisper-base \
        --serve-meshes 1x4,2x2

Checks, in order (rank 0 prints one JSON line each):
  * ``step``: for each arch of ``--train-archs`` (default h2o-danube-1.8b),
    the DaeMon step (``make_train_step(movement="daemon")``,
    DAEMON_AGGRESSIVE) from the seeded master, ``--steps`` steps of
    ``--batch`` x ``--seq`` from the token pipeline (whisper-base at full
    size: 16 x 1024, its single-card phase's; zero frames or patches as the
    stub frontends), on each mesh of ``--meshes`` (data x model) against the
    same steps on one card (rank 0 alone; ``--ref-microbatches`` splits its
    batch, so that B = 4 x 4096 fits one card): the losses within LOSS_RTOL,
    ``step_s`` (median of the steps after the first), per-card peak memory,
    the bytes of master, m, v and residual each rank holds against the
    whole, and K1/K2/K3/K4 launches a step on each rank (K1 = K2 = one per
    foldable gradient and page-class weight, from the arch's specs: 18 for
    danube; K3 and K4 none).  At full size falcon-mamba-7b trains its first
    8 of 64 layers and deepseek-v2-lite-16b its first 4 of 27, as the
    single-card phases of ``chip_smoke.py`` do;
  * ``serve``: ``serve`` of each arch in ``--serve-archs`` at full width and
    depth (whisper-base at B = 16 and 1500 frames) on each mesh of
    ``--serve-meshes`` against one card: the prefill's last logits within
    LOGIT_TOL, the first token equal wherever one card's top two logits are
    more than 2 x LOGIT_TOL apart, ``prefill_s``, ``decode_s_per_token``,
    peak memory and K3/K4 launches on each rank (from the arch: K3 once per
    GQA layer, per shared-block invocation, or per encoder layer and twice
    per decoder layer; K4 once per Mamba1 layer);
  * ``grads`` (``--grads-meshes``): for each train arch, the gradients of
    the loss at the seeded bf16 working copy on the first batch, on each
    mesh against one device (its batch split as the step's reference):
    every leaf within GRAD_TOL of its largest one-device magnitude (bf16
    gradients summed in another order);
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

from chip_smoke import (  # noqa: E402  the single-card phases' cuts and shapes
    AUDIO_BATCH,
    AUDIO_PROMPT,
    AUDIO_TRAIN_SEQ,
    MOE_ARCH,
    MOE_TRAIN_LAYERS,
    SSM_ARCH,
    SSM_TRAIN_LAYERS,
)

ARCH, SEED = "h2o-danube-1.8b", 0
TRAIN_LAYERS = {SSM_ARCH: SSM_TRAIN_LAYERS, MOE_ARCH: MOE_TRAIN_LAYERS}  # at full size
LOSS_RTOL = 1e-3  # tests/test_torch_train.py's loss tolerance
LOGIT_TOL = 8e-2  # tests/test_torch_serve.py's logit tolerance
GRAD_TOL = 5e-2  # of a leaf's largest one-device magnitude: bf16 gradients
PROB_TOL = 2e-2  # tests/test_torch_moe.py's: the MoE router's probabilities
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


def train_config(arch: str, a):
    """The arch's config as the training checks run it: reduced, or at full
    width cut in depth as the single-card phases cut it."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if a.reduced:
        return cfg.reduced()
    if arch in TRAIN_LAYERS:
        return dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
    return cfg


def train_shape(cfg, a):
    """(batch, seq) of the training checks; a VLM's text is ``--seq`` less
    its patch positions, so that the whole sequence is ``--seq`` long (its
    training attention takes lengths its chunk divides)."""
    if cfg.family == "audio" and not a.reduced:
        return AUDIO_BATCH, AUDIO_TRAIN_SEQ
    if cfg.family == "vlm":
        return a.batch, a.seq - cfg.num_prefix_tokens
    return a.batch, a.seq


def serve_shape(cfg, a):
    """(batch, prompt) of the serving checks."""
    if cfg.family == "audio" and not a.reduced:
        return AUDIO_BATCH, AUDIO_PROMPT
    return a.serve_batch, a.prompt_len


def step_launches(cfg) -> dict:
    """K1/K2/K3/K4 launches a DAEMON_AGGRESSIVE step: K1 = K2 = one per
    foldable gradient and one per page-class weight of the working copy,
    decided on the global shapes; no K3 or K4 (training attends and scans
    without them)."""
    from repro_torch.core.movement.daemon_step import is_foldable, is_page_class
    from repro_torch.models import model as M
    from repro_torch.models import nn

    shapes = [s.shape for s in nn.tree_leaves(M.model_specs(cfg))]
    n = sum(is_foldable(s) for s in shapes) + sum(is_page_class(s) for s in shapes)
    return {KERNELS[0]: n, KERNELS[1]: n, KERNELS[2]: 0, KERNELS[3]: 0}


def prefill_launches(cfg) -> dict:
    """K3/K4 launches of one prefill: K3 once per GQA attention layer (MLA
    attends without it), once per shared-block invocation of the hybrid,
    once per encoder layer and twice per decoder layer (self and cross) of
    the enc-dec; K4 once per Mamba1 layer."""
    from repro_torch.models import hybrid

    k3 = 0
    if cfg.family in ("dense", "vlm", "moe") and cfg.attn_kind != "mla":
        k3 = cfg.num_layers
    elif cfg.family == "hybrid":
        k3 = hybrid.n_invocations(cfg)
    elif cfg.family == "audio":
        k3 = cfg.enc_layers + 2 * cfg.dec_layers
    return {KERNELS[2]: k3, KERNELS[3]: cfg.num_layers if cfg.family == "ssm" else 0}


class Routes:
    """The MoE routes of a one-card run, recorded (``Routes()``), and
    replayed on the mesh run (``Routes(recorded)``): each call of
    ``models.moe.top_k`` there takes the recorded call whose probabilities
    lie nearest its own (the same layer and group, also where a
    rematerialised layer routes again in backward) and returns its experts
    with the mesh run's own probabilities at them, tallying where the mesh
    run alone would have chosen otherwise: a flip (an expert outside the one
    card's top k) or a swap (the same experts in another order).  The
    products on a mesh sum in another order, and random weights leave
    near-tied experts whose order then flips, as between JAX and the port
    (``tests/test_torch_moe.py::_Routes``); the probabilities are held
    within PROB_TOL of the one card's, so a flip happens only at a near tie.
    The identity outside a ``with`` block, and for a family without MoE."""

    def __init__(self, recorded=None):
        self.recorded = [] if recorded is None else recorded
        self.replay = recorded is not None
        self.calls = self.flips = self.swaps = 0
        self.dist = 0.0

    def __enter__(self):
        from repro_torch.models import moe

        self._real = moe.top_k
        moe.top_k = self._top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.top_k = self._real

    def _top_k(self, probs, k):
        import numpy as np
        import torch

        vals, idx = self._real(probs, k)
        p, own = probs.detach().float().cpu().numpy(), idx.cpu().numpy()
        if not self.replay:
            self.recorded.append((p, own))
            return vals, idx
        pr, ir = min((r for r in self.recorded if r[0].shape == p.shape),
                     key=lambda r: float(np.abs(r[0] - p).max()))
        self.calls += 1
        self.dist = max(self.dist, float(np.abs(pr - p).max()))
        for t in np.flatnonzero((own != ir).any(axis=1)):
            flips = len(set(own[t]) - set(ir[t]))
            self.flips += flips
            self.swaps += int((own[t] != ir[t]).sum()) - flips
        ref = torch.from_numpy(ir.copy()).to(device=idx.device, dtype=idx.dtype)
        return probs.gather(-1, ref), ref

    def stats(self) -> dict:
        return {"route_calls": self.calls, "route_flips": self.flips,
                "route_swaps": self.swaps, "route_prob_max_dist": self.dist}

    def ok(self) -> bool:
        return self.dist <= PROB_TOL


def _routes(cfg, recorded=None):
    """A :class:`Routes` for an MoE arch, else a context that does nothing."""
    import contextlib

    return Routes(recorded) if cfg.family == "moe" else contextlib.nullcontext()


def _batch(torch, cfg, host_batch, dev):
    """A pipeline batch on ``dev`` with the stub frontends' inputs."""
    from repro_torch.models import model as M

    batch = {k: torch.as_tensor(v, device=dev) for k, v in host_batch.items()}
    batch.update(M.stub_inputs(cfg, batch["tokens"]))
    return batch


def run_steps(torch, cfg, mesh, a, dev, microbatches: int, routes=None) -> dict:
    """``a.steps`` DAEMON_AGGRESSIVE steps from the seeded master, on ``mesh``
    (None: this device alone), routed by ``routes`` (see :class:`Routes`)."""
    import contextlib

    routes = routes or contextlib.nullcontext()
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
    batch_size, seq = train_shape(cfg, a)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch_size, seed=SEED))
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
            batch = _batch(torch, cfg, next(pipe), dev)
            if mesh is not None:
                batch = shd.place_tree(batch, shd.batch_sharding(mesh, rules, batch))
            runtime.reset_launches()
            _sync(torch, dev)
            t0 = time.perf_counter()
            with routes:
                params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
            launches.append({k: runtime.LAUNCHES[k] for k in KERNELS})

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


def run_serve(torch, cfg, shape, a, dev, routes) -> dict:
    """``serve_config`` of ``cfg`` on ``shape`` (None: this device), its
    prefill routed by ``routes``: the checks read the prefill, and decode
    follows tokens that may differ once the first does."""
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve_config

    _reset_peak(torch, dev)
    runtime.reset_launches()
    batch, prompt = serve_shape(cfg, a)
    make_prefill = steps.make_prefill_step

    def routed_prefill(cfg_):
        prefill = make_prefill(cfg_)

        def step(*args):
            with routes:
                return prefill(*args)

        return step

    steps.make_prefill_step = routed_prefill
    try:
        r = serve_config(cfg, batch=batch, prompt_len=prompt,
                         gen_tokens=a.gen_tokens, movement="daemon", mesh_shape=shape,
                         seed=SEED, device=dev, return_logits=True)
    finally:
        steps.make_prefill_step = make_prefill
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
        cfg = train_config(ARCH, a)
        train_archs = [x for x in a.train_archs.split(",") if x]
        for arch in train_archs:
            run_train_checks(torch, train_config(arch, a), a, dev, rank, cuda, gather, emit)
        for arch in [x for x in a.serve_archs.split(",") if x]:
            run_serve_checks(torch, arch, a, dev, rank, cuda, gather, emit)
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


def ref_microbatches(cfg, a) -> int:
    """The one-card reference's microbatches: ``--ref-microbatches``, else 2
    at full size on the card (B = 4 x 4096 does not fit one card whole), 1
    for whisper-base's 16 x 1024 and on the CPU."""
    if a.ref_microbatches is not None:
        return a.ref_microbatches
    full_card = a.device == "cuda" and not a.reduced
    return 2 if full_card and cfg.family != "audio" else 1


def run_train_checks(torch, cfg, a, dev, rank, cuda, gather, emit) -> None:
    """The ``step`` checks of one arch on each mesh of ``--meshes``, then
    its ``grads`` checks on each of ``--grads-meshes``."""
    from repro_torch.launch.mesh import make_mesh

    meshes = parse_meshes(a.meshes)
    k = ref_microbatches(cfg, a)
    batch_size, seq = train_shape(cfg, a)
    if meshes:
        ref = None
        if rank == 0:
            routes = _routes(cfg)
            ref = run_steps(torch, cfg, None, a, dev, k, routes)
            ref["routes"] = getattr(routes, "recorded", None)
        ref = gather(ref)[0]
        if cuda:
            torch.cuda.empty_cache()
    # the plain versions run on the CPU, and count no launch
    want = step_launches(cfg) if cuda else dict.fromkeys(KERNELS, 0)
    for shape in meshes:
        routes = _routes(cfg, ref["routes"])
        got = run_steps(torch, cfg, make_mesh(shape, device=dev), a, dev, 1, routes)
        mine = all(l == want for l in got["launches_per_step"])
        mine = mine and got["state_bytes"] == got["state_bytes_even"]
        mine = mine and getattr(routes, "ok", lambda: True)()
        everyone = gather({"ok": mine, "peak_memory_gb": got["peak_memory_gb"],
                           "state_bytes": got["state_bytes"],
                           "launches_per_step": got["launches_per_step"],
                           "routes": getattr(routes, "stats", dict)()})
        rel = _rel(got["losses"], ref["losses"])
        whole = sum(got["state_bytes_whole"].values())
        emit("step", rel <= LOSS_RTOL and all(e["ok"] for e in everyone),
             mesh=list(shape), arch=cfg.name, num_layers=cfg.num_layers, batch=batch_size,
             seq=seq, steps=a.steps, movement="daemon (DAEMON_AGGRESSIVE)",
             losses=got["losses"], one_card_losses=ref["losses"], loss_max_rel=rel,
             loss_rtol=LOSS_RTOL, one_card_microbatches=k,
             step_s=got["step_s"], step_s_each=got["step_s_each"],
             one_card_step_s=ref["step_s"], peak_memory_gb_per_rank=[
                 e["peak_memory_gb"] for e in everyone],
             one_card_peak_memory_gb=ref["peak_memory_gb"],
             state_bytes_per_rank=[sum(e["state_bytes"].values()) for e in everyone],
             state_bytes_even_split=sum(got["state_bytes_even"].values()),
             state_bytes_whole=whole, state_bytes_whole_by_part=got["state_bytes_whole"],
             state_share_per_rank=[sum(e["state_bytes"].values()) / whole for e in everyone],
             launches_want=want, launches_per_step_rank0=got["launches_per_step"],
             launches_ok_per_rank=[e["ok"] for e in everyone],
             routes_as_one_card_per_rank=[e["routes"] for e in everyone])
        if cuda:
            torch.cuda.empty_cache()
    if a.grads_meshes:
        run_grads(torch, cfg, a, dev, rank, gather, emit, k)
        if cuda:
            torch.cuda.empty_cache()


def run_serve_checks(torch, arch, a, dev, rank, cuda, gather, emit) -> None:
    """The ``serve`` checks of one arch, at full width and depth (or
    reduced), on each mesh of ``--serve-meshes`` against one card."""
    from repro_torch.configs import get_config

    scfg = get_config(arch)
    scfg = scfg.reduced() if a.reduced else scfg
    meshes = parse_meshes(a.serve_meshes)
    if not meshes:
        return
    batch, prompt = serve_shape(scfg, a)
    ref = None
    if rank == 0:
        routes = _routes(scfg)
        ref = run_serve(torch, scfg, None, a, dev, routes)
        ref["routes"] = getattr(routes, "recorded", None)
    ref = gather(ref)[0]
    # the plain versions count no launch
    want = prefill_launches(scfg) if cuda else {KERNELS[2]: 0, KERNELS[3]: 0}
    for shape in meshes:
        if cuda:
            torch.cuda.empty_cache()
        routes = _routes(scfg, ref["routes"])
        got = run_serve(torch, scfg, shape, a, dev, routes)
        everyone = gather({"peak_memory_gb": got["peak_memory_gb"],
                           "launches": got["launches"],
                           "routes": getattr(routes, "stats", dict)(),
                           "routes_ok": getattr(routes, "ok", lambda: True)()})
        err = float((got["logits"] - ref["logits"]).abs().max())
        # the first token is the prefill logits' argmax: it must agree
        # wherever one card's top two are further apart than the two
        # runs' logits may be; later tokens follow the first
        # difference, and random weights at full width leave near ties
        top2 = ref["logits"].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
        first = [g[0] == r[0] for g, r in zip(got["tokens"], ref["tokens"])]
        first_ok = all(f or not c for f, c in zip(first, clear.tolist()))
        launched = all(e["launches"][kk] == n for e in everyone for kk, n in want.items())
        routed = all(e["routes_ok"] for e in everyone)
        emit("serve", err <= LOGIT_TOL and launched and first_ok and routed,
             mesh=list(shape), arch=scfg.name, batch=batch, prompt_len=prompt,
             gen_tokens=a.gen_tokens, logits_max_abs_err=err, logit_tol=LOGIT_TOL,
             tokens_equal=got["tokens"] == ref["tokens"],
             first_token_equal=first, first_token_margin_clear=clear.tolist(),
             prefill_s=got["prefill_s"], one_card_prefill_s=ref["prefill_s"],
             decode_s_per_token=got["decode_s_per_token"],
             one_card_decode_s_per_token=ref["decode_s_per_token"],
             peak_memory_gb_per_rank=[e["peak_memory_gb"] for e in everyone],
             one_card_peak_memory_gb=ref["peak_memory_gb"], launches_want=want,
             launches_per_rank=[e["launches"] for e in everyone],
             one_card_launches=ref["launches"],
             routes_as_one_card_per_rank=[e["routes"] for e in everyone])


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


def run_grads(torch, cfg, a, dev, rank, gather, emit, microbatches: int = 1) -> None:
    """The ``grads`` checks of ``cfg`` (rank 0's reference over
    ``microbatches`` of the batch, as its step's)."""
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
    batch_size, seq = train_shape(cfg, a)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch_size, seed=SEED))
    batch = _batch(torch, cfg, next(pipe), dev)
    pipe.close()
    want = None
    if rank == 0:
        routes = _routes(cfg)
        with routes:
            g, m = steps._microbatched_grads(cfg, params, batch, microbatches)
        want = ([x.float().cpu() for x in nn.tree_leaves(g)], float(m["loss"]),
                getattr(routes, "recorded", None))
        del g
    want = gather(want)[0]
    for shape in parse_meshes(a.grads_meshes):
        mesh = make_mesh(shape, device=dev)
        rules = shd.base_rules(mesh, fsdp=True)
        shd.activate(mesh, rules)
        try:
            dp = shd.place_tree(params, shd.sharding_for_specs(mesh, rules, specs))
            db = shd.place_tree(batch, shd.batch_sharding(mesh, rules, batch))
            routes = _routes(cfg, want[2])
            with routes:
                g, m = steps._value_and_grad(cfg, dp, db)
            got = [shd.to_global(x).float().cpu() for x in nn.tree_leaves(g)]
            del g, dp
        finally:
            shd.deactivate()
        stats = gather((getattr(routes, "stats", dict)(), getattr(routes, "ok", lambda: True)()))
        if rank == 0:
            rel = {path: float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for path, x, y in zip(_paths(specs), got, want[0])}
            worst = max(rel, key=rel.get)
            emit("grads", rel[worst] <= GRAD_TOL and all(o for _, o in stats),
                 mesh=list(shape), model=cfg.name, loss=float(m["loss"]),
                 one_device_loss=want[1], one_device_microbatches=microbatches,
                 worst_leaf=worst, worst_rel=rel[worst], grad_tol=GRAD_TOL, rel_by_leaf=rel,
                 routes_as_one_card_per_rank=[st for st, _ in stats])
        else:
            emit("grads", True, mesh=list(shape), model=cfg.name)


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
    ap.add_argument("--train-archs", default=ARCH,
                    help="archs of the step and grads checks (comma list)")
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
                    help="the one-card step's microbatches (default 2 on the card at full "
                         "size, whisper-base 1)")
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds for every rank")
    a = ap.parse_args()
    a.batch = a.batch or 4
    a.seq = a.seq or (32 if a.reduced else 4096)
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
