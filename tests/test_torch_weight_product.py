"""``sharding.weight_product`` on two spawned gloo ranks against one device:
a block that is a partial sum over the ranks is summed and reduced in f32,
then rounded once, as one device rounds each whole sum once.

Three products of seeded bf16 operands, each with the one block that is a
partial sum over the ranks:

  * ``row``: w split over K on a (1, 2) mesh, the result a partial sum;
  * ``column``: w split over N on a (1, 2) mesh, x's gradient a partial sum;
  * ``fsdp``: w split over K on ``data`` of a (2, 1) mesh, gathered for the
    product, with x's rows split there: w's gradient a partial sum.

The result and both gradients must equal one device's bf16 values but for
rare ties (under 1 % of elements): the f32 sums differ from one device's
only in their order.  Partial sums rounded to bf16 before the reduction
differ in most elements.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

REPO = Path(__file__).resolve().parents[1]
RUN_SECONDS = 120  # about 10 s here
MISMATCH_TOL = 1e-2  # share of bf16 elements off one device's

pytestmark = pytest.mark.slow

CHILD = r"""
import json, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.sharding import place_as, to_global, weight_product

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                        timeout=timedelta(seconds=90))
rng = np.random.default_rng(0)
B, S, K, N = 4, 16, 512, 256
bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
x0 = bf(rng.standard_normal((B, S, K)))
w0 = bf(rng.standard_normal((K, N)) / np.sqrt(K))
g0 = bf(rng.standard_normal((B, S, N)))

x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
out = torch.matmul(x, w)
out.backward(g0)
ref = {"out": out.detach(), "x_grad": x.grad, "w_grad": w.grad}

R = Replicate()
cases = {"row": ((1, 2), (R, R), (R, Shard(0)), "out"),
         "column": ((1, 2), (R, R), (R, Shard(1)), "x_grad"),
         "fsdp": ((2, 1), (Shard(0), R), (Shard(0), R), "w_grad")}
res = {}
for name, (shape, xpl, wpl, partial) in cases.items():
    mesh = make_mesh(shape, device=torch.device("cpu"))
    x = place_as(x0, mesh, xpl).requires_grad_()
    w = place_as(w0, mesh, wpl).requires_grad_()
    out = weight_product(x, w)
    out.backward(place_as(g0, mesh, out.placements))
    got = {"out": to_global(out.detach()), "x_grad": to_global(x.grad),
           "w_grad": to_global(w.grad)}
    res[name] = {"partial": partial,
                 "mismatch": {k: float((got[k] != ref[k]).float().mean()) for k in ref},
                 "max_abs": {k: float((got[k].float() - ref[k].float()).abs().max()) for k in ref}}
if rank == 0:
    print(json.dumps(res), flush=True)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    store = tmp_path_factory.mktemp("weight_product") / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(store)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=RUN_SECONDS))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    assert [p.returncode for p in procs] == [0, 0], [err[-3000:] for _, err in outs]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["row", "column", "fsdp"])
def test_partial_sums_round_once(results, case):
    r = results[case]
    assert r["mismatch"][r["partial"]] <= MISMATCH_TOL, r
    assert max(r["mismatch"].values()) <= MISMATCH_TOL, r
