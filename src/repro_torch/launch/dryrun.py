"""Multi-device dry run (port of ``repro.launch.dryrun``): trace one step of
an (arch x shape x mesh) cell on abstract inputs, count one rank's work, and
write its roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --cell train_4k --mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every live cell, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --cell train_4k \\
      --mesh 2x2 --reduced --device cpu

Where JAX lowers and compiles the step for a fake-device mesh, the port runs
it eagerly on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage) laid out as DTensors over a ``DeviceMesh`` of a ``fake`` process
group (rank 0 of the mesh's size; its collectives move nothing), and counts
rank 0's aten ops with ``launch/hlo_cost.py``.  No device memory is
allocated and no kernel launches: on ``--device cuda`` (the default) each
kernel wrapper reports the launch it would make and its ``cost()`` instead.
On ``--device cpu`` the plain versions' ops run and are counted; K3's plain
version forms the whole score matrix, so its FLOPs exceed the kernel's kept
(q, k) pairs.

The record has JAX's fields.  ``lower_s`` is the trace's seconds and
``compile_s`` 0.0 (nothing compiles); ``memory_analysis`` has no
``generated_code_size_in_bytes``, and its ``temp_size_in_bytes`` is the
counter's ``peak_live_bytes``.  ``dot_flops`` and ``kernel_launches`` are
added.  JAX's ``--save-hlo`` has no counterpart: there is no HLO text.
Each ``--all`` sub-cell runs in its own process, as in JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as devices
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import movement as mv
from repro_torch.launch import hlo_cost, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rl
from repro_torch.models import model as M
from repro_torch.models import nn
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd


def auto_k(cfg, cell, n_dp: int, reduced: bool) -> int:
    if reduced:
        return 1
    return steps.auto_microbatches(cfg, cell.seq_len, cell.global_batch, n_dp)


def _fake_tree(abstract, shardings, device):
    """Fake tensors for a tree of ``adamw.LeafShape`` (dicts and named
    tuples of them), each placed by its sharding (``None``: a plain tensor,
    the same on every rank)."""
    if isinstance(abstract, adamw.LeafShape):
        x = torch.empty(abstract.shape, dtype=abstract.dtype, device=device)
        return x if shardings is None else shd.place(x, shardings)
    if isinstance(abstract, dict):
        return {k: _fake_tree(v, shardings[k], device) for k, v in abstract.items()}
    return type(abstract)(*(_fake_tree(a, s, device) for a, s in zip(abstract, shardings)))


def _trace(cfg, cell, mesh, rules, *, movement, movement_cfg, reduced, params_dtype,
           microbatches, device, rec):
    """-> (counts, argument bytes, donated bytes, output) of one step."""
    specs = M.model_specs(cfg)
    psh = shd.sharding_for_specs(mesh, rules, specs)
    counter = hlo_cost.OpCounter()

    def placed_params(dtype):
        return shd.place_tree(nn.abstract_params(specs, dtype, device), psh)

    if cell.kind == "train":
        batch = M.input_specs(cfg, cell, device)
        batch = shd.place_tree(batch, shd.batch_sharding(mesh, rules, batch))
        k = microbatches or auto_k(cfg, cell, steps.dp_degree(mesh), reduced)
        rec["microbatches"] = k
        step = steps.make_train_step(cfg, movement=movement, movement_cfg=movement_cfg,
                                     num_microbatches=k)
        if movement == "daemon":
            params = placed_params(torch.bfloat16)  # the working copy on the wire
            master = placed_params(torch.float32)
            opt = _fake_tree(mv.init_abstract(master), mv.state_shardings(psh), device)
        else:
            params = placed_params(getattr(torch, params_dtype) if params_dtype
                                   else torch.float32)
            opt = _fake_tree(adamw.init_abstract(params), adamw.AdamWState(None, psh, psh),
                             device)
        args, donated = (params, opt, batch), (params, opt)
    elif cell.kind == "prefill":
        batch = M.input_specs(cfg, cell, device)
        batch = shd.place_tree(batch, shd.batch_sharding(mesh, rules, batch))
        step = steps.make_prefill_step(cfg)
        args, donated = (placed_params(torch.bfloat16), batch), ()
    else:  # decode
        inp = M.input_specs(cfg, cell, device)
        csh = shd.cache_sharding(mesh, rules, M.cache_specs(cfg, cell.global_batch,
                                                             cell.seq_len))
        cache = shd.place_tree(inp["cache"], csh)
        token = shd.place(inp["token"], shd.batch_sharding(mesh, rules, inp["token"]))
        step = steps.make_decode_step(cfg)
        args, donated = (placed_params(torch.bfloat16), cache, token, inp["pos"]), (cache,)
    counts = counter.analyze(step, *args)
    return counts, hlo_cost.local_bytes(args), hlo_cost.local_bytes(donated), counter.output


def run_cell(arch: str, cell_name: str, mesh_spec: str, *, movement: str = "baseline",
             reduced: bool = False, fsdp: bool = True, remat: str = "",
             params_dtype: str = "", microbatches: int = 0, cache_shard: str = "seq",
             ssm_algo: str = "", device=None, movement_cfg=None) -> dict:
    """The record of one cell (see the module's docstring).  Makes its own
    fake process group and destroys it before returning; raises if a process
    group is already initialised.  ``movement_cfg`` (a ``MovementConfig``;
    default ``DAEMON_DEFAULT``, as JAX's dry run) sets a daemon train step's
    engine."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dev = devices.resolve(device)
    if dist.is_initialized():
        raise RuntimeError("run_cell makes its own fake process group; one is already "
                           "initialised")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if ssm_algo:
        cfg = dataclasses.replace(cfg, ssm_algo=ssm_algo)
    cell = SHAPES[cell_name]
    shape = mesh_lib.parse_shape(mesh_spec)
    n_dev = int(np.prod(shape))
    if reduced:
        cell = dataclasses.replace(cell, seq_len=128, global_batch=max(8, n_dev // 8))

    rec = {
        "arch": arch, "cell": cell_name, "mesh": mesh_spec, "kind": cell.kind,
        "movement": movement, "n_devices": n_dev, "ok": False,
    }
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_dev)
    try:
        mesh = mesh_lib.make_mesh(shape, device=dev)
        rules = shd.base_rules(mesh, fsdp=fsdp, cache_shard=cache_shard)
        shd.activate(mesh, rules)
        t0 = time.perf_counter()
        with FakeTensorMode():
            counts, arg_bytes, alias_bytes, out = _trace(
                cfg, cell, mesh, rules, movement=movement, movement_cfg=movement_cfg,
                reduced=reduced,
                params_dtype=params_dtype, microbatches=microbatches, device=dev, rec=rec)
            out_bytes = hlo_cost.local_bytes(out)
            del out
        rec["lower_s"] = time.perf_counter() - t0
        rec["compile_s"] = 0.0

        roof, coll = rl.analyze(counts, n_dev)
        rec.update(roof.as_dict())
        rec["dot_flops"] = counts["dot_flops"]
        rec["kernel_launches"] = counts["kernel_launches"]
        rec["collectives"] = {
            "operand_bytes": coll.operand_bytes,
            "result_bytes": coll.result_bytes,
            "counts": coll.counts,
        }
        rec["memory_analysis"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": counts["peak_live_bytes"],
            "alias_size_in_bytes": alias_bytes,
        }
        if not reduced:
            rec["model_flops"] = rl.model_flops(cfg, cell)
            rec["n_params"] = M.param_count(cfg)
            rec["n_params_active"] = M.param_count(cfg, active_only=True)
            if rec["flops"]:
                # per-device flops x n_dev vs global model flops
                rec["model_flops_ratio"] = rec["model_flops"] / (rec["flops"] * n_dev)
        rec["ok"] = True

        print(f"== {arch} / {cell_name} / {mesh_spec} / {movement} ==")
        print(f"memory_analysis: {rec['memory_analysis']}")
        print(
            f"cost_analysis: flops={rec['flops']:.3e} bytes={rec['hbm_bytes']:.3e} "
            f"coll={rec['collective_bytes']:.3e} kernels={rec['kernel_launches']}"
        )
        print(
            f"terms: compute={rec['t_compute_s']:.4f}s memory={rec['t_memory_s']:.4f}s "
            f"collective={rec['t_collective_s']:.4f}s -> {rec['bottleneck']}"
        )
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"== {arch} / {cell_name} / {mesh_spec} FAILED: {rec['error']}", file=sys.stderr)
    finally:
        shd.deactivate()
        dist.destroy_process_group()
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--cell", default="")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--movement", default="baseline", choices=["baseline", "daemon"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default="")
    ap.add_argument("--params-dtype", default="")
    ap.add_argument("--microbatches", type=int, default=0, help="0 = auto")
    ap.add_argument("--cache-shard", default="seq", choices=["seq", "dh"])
    ap.add_argument("--ssm-algo", default="", choices=["", "scan", "ssd"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--all", action="store_true", help="run every live cell x both meshes via subprocesses")
    ap.add_argument("--archs", default="", help="comma list filter for --all")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    if args.all:
        import subprocess

        from repro_torch.configs import ARCHS

        outdir = Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        archs = args.archs.split(",") if args.archs else list(ARCHS)
        jobs = []
        for arch in archs:
            cfg = get_config(arch)
            for cell in cfg.live_cells():
                for mesh_spec in ("16x16", "2x16x16"):
                    jobs.append((arch, cell.name, mesh_spec))
        failures = 0
        for i, (arch, cell, mesh_spec) in enumerate(jobs):
            tag = f"{arch}_{cell}_{mesh_spec}_{args.movement}"
            outfile = outdir / f"{tag}.json"
            if outfile.exists() and json.loads(outfile.read_text()).get("ok"):
                print(f"[{i+1}/{len(jobs)}] {tag}: cached ok")
                continue
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--cell", cell, "--mesh", mesh_spec,
                "--movement", args.movement, "--out", str(outdir),
            ]
            if args.no_fsdp:
                cmd.append("--no-fsdp")
            if args.device:
                cmd += ["--device", args.device]
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True)
            ok = outfile.exists() and json.loads(outfile.read_text()).get("ok")
            failures += 0 if ok else 1
            print(
                f"[{i+1}/{len(jobs)}] {tag}: {'ok' if ok else 'FAIL'} ({time.time()-t0:.0f}s)",
                flush=True,
            )
            if not ok:
                sys.stderr.write((r.stdout or "")[-2000:] + (r.stderr or "")[-3000:] + "\n")
        print(f"dry-run batch done: {len(jobs) - failures}/{len(jobs)} ok")
        sys.exit(1 if failures else 0)

    rec = run_cell(
        args.arch, args.cell, args.mesh, movement=args.movement,
        reduced=args.reduced, fsdp=not args.no_fsdp,
        remat=args.remat, params_dtype=args.params_dtype,
        microbatches=args.microbatches, cache_shard=args.cache_shard,
        ssm_algo=args.ssm_algo, device=args.device,
    )
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    tag = f"{args.arch}_{args.cell}_{args.mesh}_{args.movement}"
    if args.reduced:
        tag += "_reduced"
    (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    sys.exit(0 if rec.get("ok") else 1)


if __name__ == "__main__":
    main()
