#!/usr/bin/env python3
"""How far one card's own prefill logits move when only the rounding of its
bf16 weight products changes: the yardstick for the logit gaps between one
card and a mesh (``tools/sharded_ranks.py``'s ``serve`` checks).

    python3 tools/rounding_witness.py                # one card, full size
    python3 tools/rounding_witness.py --device cpu --reduced

For each arch of ``--archs``, ``serve`` runs on one device as the
``serve`` checks' one-card reference runs it (full width and depth, B = 2,
an 8192-token prompt; MoE routes recorded), then once for each variant with
every bf16 weight product (``nn.dense``) computed another way, the same
routes replayed (``sharded_ranks.Routes``):

  * ``f32_sums``: one product whose f32 sums are written out and rounded
    once to bf16 (another GEMM kernel, so another order of the same sums);
  * ``k_blocks4``: K cut into 4 contiguous blocks, each block's product
    summed in f32, the 4 added in f32 and rounded once: the order of a
    row-parallel product's sums at TP 4 (``sharding.weight_product``), here
    taken by every product;
  * ``row_blocks4``: as ``k_blocks4``, but only the products whose weight
    the rules split over K at (1, 4) (the row-parallel ones, told by their
    (K, N) shapes, read from the arch's specs), leaving out a shape that a
    column-parallel weight has too; the others as they are;
  * ``row_blocks4_shared``: as ``row_blocks4``, with those shared shapes;
  * ``row_blocks2``: as ``row_blocks4`` at TP 2 (the (2, 2) mesh's order);
  * ``exact_reductions``: the plain products with cuBLAS's reduced-precision
    (bf16) split-K reductions turned off.

One JSON line per (arch, variant): the prefill's last logits' max abs error
against the plain run, beside LOGIT_TOL; then one summary line.  f32
products (the head, the MoE router) are left as they are.  For each arch of
``--grads-archs``, likewise the gradients of the loss at the seeded bf16
working copy on the first batch, as the ``grads`` checks' one-card
reference takes them (B = 4 x 4096 on 2 microbatches at full size): every
leaf's max abs error over its largest plain magnitude, beside GRAD_TOL.
Under autograd a block's product is an f32 GEMM of the upcast operands (the
same sums; ``torch.mm``'s f32 output has no gradient).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

ARCHS = "falcon-mamba-7b,zamba2-1.2b,deepseek-v2-lite-16b"
VARIANTS = ("f32_sums", "k_blocks4", "row_blocks4", "row_blocks4_shared", "exact_reductions")
BLOCKS = {"f32_sums": (1, None), "k_blocks4": (4, None), "row_blocks4": (4, 4),
          "row_blocks4_shared": (4, 4), "row_blocks2": (2, 2)}  # (blocks, TP of the rows)


def row_parallel(cfg, tp: int = 4, shared: bool = False) -> set:
    """The (K, N) shapes of ``cfg``'s weights that the rules split over K on
    a (1, ``tp``) mesh; with ``shared``, also those that a weight split over
    N has too."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import model as M
    from repro_torch.models import nn
    from repro_torch.runtime import sharding as shd

    mesh = MeshShape(("data", "model"), (1, tp))
    rules = shd.base_rules(mesh, fsdp=True)
    rows, cols = set(), set()
    for s in nn.tree_leaves(M.model_specs(cfg)):
        spec = shd.spec_for(mesh, rules, s.axes, s.shape) + (None,) * len(s.shape)
        k, n = spec[len(s.shape) - 2], spec[len(s.shape) - 1]
        if len(s.shape) >= 2 and "model" in (k, n):
            (rows if k == "model" else cols).add(tuple(s.shape[-2:]))
    return rows if shared else rows - cols


@contextlib.contextmanager
def products(variant: str, cfg):
    """``nn.dense`` computed as ``variant`` says, inside the block."""
    import torch

    from repro_torch.models import nn
    from repro_torch.runtime.sharding import mm_f32

    blocks, tp = BLOCKS.get(variant, (None, None))
    rows = None if tp is None else row_parallel(cfg, tp, shared=variant.endswith("shared"))
    plain, flag = nn.dense, torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction

    def dense(x, w):
        w = w.to(x.dtype)
        if x.dtype == torch.float32 or (rows is not None and tuple(w.shape) not in rows):
            return torch.matmul(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        out = None
        for xb, wb in zip(x2.tensor_split(blocks, dim=1), w.tensor_split(blocks, dim=0)):
            xb, wb = xb.contiguous(), wb.contiguous()
            part = xb.float() @ wb.float() if torch.is_grad_enabled() else mm_f32(xb, wb)
            out = part if out is None else out + part
        return out.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])

    if blocks is not None:
        nn.dense = dense
    else:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        nn.dense = plain
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def one_card_grads(torch, sr, cfg, a, dev, microbatches: int):
    """The gradients of ``sharded_ranks.run_grads``' one-card reference, on
    the host, and their leaves' paths."""
    from repro_torch.core import movement as mv
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import nn

    specs = M.model_specs(cfg)
    params = mv.working_copy(
        nn.init_params(specs, torch.Generator(device=dev).manual_seed(sr.SEED), dev),
        mv.DAEMON_DEFAULT)
    batch_size, seq = sr.train_shape(cfg, a)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch_size, seed=sr.SEED))
    batch = sr._batch(torch, cfg, next(pipe), dev)
    pipe.close()
    g, _ = steps._microbatched_grads(cfg, params, batch, microbatches)
    out = [x.float().cpu() for x in nn.tree_leaves(g)]
    del g, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, sr._paths(specs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=ARCHS)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--grads-archs", default="")
    ap.add_argument("--grads-variants", default="row_blocks2")
    ap.add_argument("--reduced", action="store_true")
    a = ap.parse_args()
    a.serve_batch, a.prompt_len, a.gen_tokens = (2, 32, 4) if a.reduced else (2, 8192, 16)
    a.batch, a.seq = 4, 32 if a.reduced else 4096

    import torch

    import sharded_ranks as sr
    from repro_torch.configs import get_config

    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("rounding_witness: no card", file=sys.stderr)
            return 1
        from repro_torch.kernels import runtime

        runtime.build()
        torch.backends.cuda.matmul.allow_tf32 = False  # as sharded_ranks.py
    dev = torch.device(a.device)
    worst = {}
    for arch in [x for x in a.archs.split(",") if x]:
        cfg = get_config(arch)
        cfg = cfg.reduced() if a.reduced else cfg
        routes = sr._routes(cfg)
        ref = sr.run_serve(torch, cfg, None, a, dev, routes)
        recorded = getattr(routes, "recorded", None)
        for variant in [v for v in a.variants.split(",") if v]:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            routes = sr._routes(cfg, recorded)
            with products(variant, cfg):
                got = sr.run_serve(torch, cfg, None, a, dev, routes)
            err = float((got["logits"] - ref["logits"]).abs().max())
            worst[f"{cfg.name}/{variant}"] = err
            print(json.dumps({"witness": variant, "arch": cfg.name, "batch": a.serve_batch,
                              "prompt_len": a.prompt_len, "logits_max_abs_err": err,
                              "logit_tol": sr.LOGIT_TOL,
                              "logits_max_abs": float(ref["logits"].abs().max()),
                              "first_token_equal": [g[0] == r[0] for g, r in
                                                    zip(got["tokens"], ref["tokens"])],
                              "routes": getattr(routes, "stats", dict)()}), flush=True)
    for arch in [x for x in a.grads_archs.split(",") if x]:
        cfg = get_config(arch)
        cfg = cfg.reduced() if a.reduced else cfg
        k = 1 if a.reduced or dev.type != "cuda" else 2
        ref, paths = one_card_grads(torch, sr, cfg, a, dev, k)
        for variant in [v for v in a.grads_variants.split(",") if v]:
            with products(variant, cfg):
                got, _ = one_card_grads(torch, sr, cfg, a, dev, k)
            rel = {p: float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for p, x, y in zip(paths, got, ref)}
            w = max(rel, key=rel.get)
            worst[f"{cfg.name}/grads/{variant}"] = rel[w]
            print(json.dumps({"witness": variant, "grads": cfg.name, "microbatches": k,
                              "worst_leaf": w, "worst_rel": rel[w], "grad_tol": sr.GRAD_TOL,
                              "rel_by_leaf": rel}), flush=True)
    line = {"tool": "rounding_witness", "device": a.device, "reduced": a.reduced,
            "worst": worst}  # logits' max abs error; grads: the worst leaf's
    if a.device == "cuda":
        from chip_smoke import nvidia_smi

        line["nvidia_smi"] = nvidia_smi()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
