"""Logical-axis -> mesh-axis resolution (port of ``repro.runtime.sharding``)
onto a ``torch.distributed`` ``DeviceMesh`` and DTensor placements.

Model code annotates parameters (via ``ParamSpec.axes``) and activations (via
``nn.logical_constraint``) with *logical* names; this module maps them onto
the mesh:

  TP axis ("model"):  vocab, mlp, heads, kv_heads, experts, ssm_inner, ssm_heads
  FSDP axis ("data"): embed (the d_model dim of every weight matrix)
  DP axes:            act_batch -> ("pod", "data") / ("data",)

A tensor's *spec* is a tuple of per-dim entries (``None``, a mesh axis name,
or a tuple of them), equal entry for entry to JAX's ``PartitionSpec``.  A
mesh axis is dropped from a dim it does not divide, and trailing ``None``s
are trimmed, as in JAX.  ``placements_for`` turns a spec into DTensor
placements, one per mesh dim: ``Shard(d)`` where the mesh axis appears in
dim ``d``'s entry, ``Replicate()`` elsewhere; an entry ``("pod", "data")``
shards dim ``d`` on both, pod-major as JAX lays it out.

``base_rules``/``spec_for`` read only ``mesh.axis_names`` and
``mesh.shape[name]`` of a ``launch.mesh.MeshShape``, or a ``DeviceMesh``'s
names and sizes, so the rules resolve without ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.models import nn
from repro_torch.models.nn import ParamSpec

MeshAxes = Any  # str | tuple[str, ...] | None
Spec = Tuple[MeshAxes, ...]


def base_rules(mesh, *, fsdp: bool = True, zero_weights_on_pod: bool = False,
               cache_shard: str = "seq") -> Dict[str, MeshAxes]:
    axes = axis_names(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    fsdp_axes: MeshAxes = None
    if fsdp:
        fsdp_axes = dp_axes if zero_weights_on_pod else tuple(a for a in dp_axes if a != "pod")
        if len(fsdp_axes) == 1:
            fsdp_axes = fsdp_axes[0]
        elif not fsdp_axes:
            fsdp_axes = None
    model = "model" if "model" in axes else None
    return {
        "vocab": model,
        "mlp": model,
        "heads": model,
        "kv_heads": model,
        "experts": model,
        "ssm_inner": model,
        "ssm_heads": model,
        "embed": fsdp_axes,
        # decode caches take the TP axis on exactly one dim:
        #   seq — split-KV (baseline); dh — head_dim split
        "kv_seq": model if cache_shard == "seq" else None,
        "kv_dh": model if cache_shard == "dh" else None,
        "lora": None,
        "lora_cache": None,
        "experts_router": None,
        "layers": None,
        "act_batch": dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None),
    }


def _entry_size(mesh, entry: MeshAxes) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return axis_size(mesh, entry)
    return int(np.prod([axis_size(mesh, a) for a in entry]))


def spec_for(mesh, rules: Dict[str, MeshAxes], axes: Tuple[Optional[str], ...],
             shape: Tuple[int, ...]) -> Spec:
    """Per-dim mesh entries for one tensor, dropping non-divisible mesh axes."""
    entries = []
    for dim, name in zip(shape, axes):
        entry = rules.get(name) if name else None
        if entry is not None and dim % _entry_size(mesh, entry) != 0:
            entry = None  # replicate: no uneven shards
        entries.append(entry)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements_for(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each dim of a tensor lies (JAX's
    ``NamedSharding``).  A leaf, not a container, in the port's trees."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)


def sharding_for_specs(mesh, rules: Dict[str, MeshAxes], specs: Any) -> Any:
    """ParamSpec tree -> NamedSharding tree (same structure)."""

    def one(s: ParamSpec) -> NamedSharding:
        return NamedSharding(mesh, spec_for(mesh, rules, s.axes, s.shape))

    return nn.spec_tree_map(one, specs)


def batch_sharding(mesh, rules: Dict[str, MeshAxes], batch_specs: Any) -> Any:
    """Shard every array-like input on its leading (batch) dim; scalars
    replicated.  ``batch_specs`` holds anything with a ``shape``."""
    dp = rules.get("act_batch")

    def one(x):
        shape = tuple(x.shape)
        if not shape:
            return NamedSharding(mesh, ())
        entry = dp
        if entry is not None and shape[0] % _entry_size(mesh, entry) != 0:
            entry = None
        return NamedSharding(mesh, (entry,))

    return nn.tree_map(one, batch_specs)


def cache_sharding(mesh, rules: Dict[str, MeshAxes], cache_specs: Any) -> Any:
    return sharding_for_specs(mesh, rules, cache_specs)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def local_range(x, dim: int) -> Tuple[int, int]:
    """(first index, count) of dim ``dim`` of the DTensor ``x`` on this rank
    (the mesh dims that shard it split it evenly, in mesh order)."""
    from torch.distributed.tensor import Shard

    lo, n = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= x.device_mesh.size(i)
            lo += x.device_mesh.get_local_rank(i) * n
    return lo, n


def with_placements(x: torch.Tensor, mesh, placements):
    """``x`` redistributed to ``placements`` (a DTensor), or, if plain and
    the same on every rank, placed so."""
    placements = tuple(placements)
    if not nn.is_dtensor(x):
        return place_as(x, mesh, placements)
    return x if tuple(x.placements) == placements else x.redistribute(mesh, placements)


def head_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Attention's operands q (B, Sq, H, D) and k, v (B, Skv, KVH, D) as
    DTensors, laid out so that each rank holds whole rows of its batch rows
    and q heads -> (q, k, v local tensors, wrap), ``wrap`` turning a local
    (B, Sq, H, Dv) result back into a DTensor.  q keeps its shards of dims 0
    and 2 and gathers the rest.  Where the mesh dims that split q's heads
    also split the KV heads evenly, k/v take q's placements and each rank's
    GQA ratio is the global one; otherwise k/v are gathered over the heads
    and each rank keeps the KV heads its q heads read (one KV head a q head
    where its q heads do not start and end on a group boundary).  All of it
    is differentiable."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    qpl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                for p in q.placements)
    n_heads = 1
    for i, p in enumerate(qpl):
        if p == Shard(2):
            n_heads *= mesh.size(i)
    h, kvh = q.shape[2], k.shape[2]
    kv_split = kvh % n_heads == 0
    kvpl = tuple(p if p == Shard(0) or (p == Shard(2) and kv_split) else Replicate()
                 for p in qpl)
    q = with_placements(q, mesh, qpl)
    k, v = (with_placements(t, mesh, kvpl) for t in (k, v))
    # where q's heads are split and k/v's are not, each rank's k/v gradient
    # holds only its q heads' part: partial sums over those mesh dims
    kvgrad = tuple(Partial() if p == Shard(2) and r == Replicate() else r
                   for p, r in zip(qpl, kvpl))
    ql = q.to_local()
    kl, vl = k.to_local(grad_placements=kvgrad), v.to_local(grad_placements=kvgrad)
    if not kv_split:
        group = h // kvh
        lo, n = local_range(q, 2)
        if lo % group == 0 and n % group == 0:
            idx = slice(lo // group, (lo + n) // group)
        else:
            idx = torch.arange(lo, lo + n, device=kl.device) // group
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    shape = (*q.shape[:3], v.shape[3])
    return ql, kl, vl, lambda out: from_block(out, mesh, qpl, shape)


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` itself if a DTensor, else the plain tensor (the same on every
    rank) as a replicated DTensor on ``mesh``, whose gradient is summed over
    the ranks that use it."""
    from torch.distributed.tensor import DTensor, Replicate

    if nn.is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def to_block(x: torch.Tensor, placements, grad_placements=None) -> torch.Tensor:
    """This rank's block of the DTensor ``x`` laid out by ``placements``, as
    a plain tensor; ``grad_placements`` says how the block's gradient lies
    (default: as ``placements``; ``Partial`` where each rank's gradient holds
    only its own part of the work)."""
    x = with_placements(x, x.device_mesh, placements)
    return x.to_local(grad_placements=None if grad_placements is None else tuple(grad_placements))


def from_block(block: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """The DTensor of global ``shape`` whose block on this rank is ``block``."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    return DTensor.from_local(block.contiguous(), mesh, tuple(placements), run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def weight_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x (..., K), w (K, N)) on local blocks, for ``nn.dense``.
    On a data-parallel mesh dim (any but ``model``) that splits x's rows, w
    is gathered there (FSDP).  On any other mesh dim w keeps its split: over
    N, x is whole there and the result is split over N; over K, x is split
    over K and each rank's partial sums are reduced to the whole product;
    with w whole, x keeps a split of its rows.  Differentiable: each block's
    gradient is declared as the ranks hold it."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (w if nn.is_dtensor(w) else x).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    last, k, n = x.ndim - 1, w.ndim - 2, w.ndim - 1
    names = mesh.mesh_dim_names
    xpl, wpl, opl, xgrad, wgrad = [], [], [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        rows = xp == Shard(0) and last > 0
        if not isinstance(wp, Shard) or (rows and names[i] != "model"):
            wp = Replicate()
        if wp == Shard(k):
            xq, oq, xg, wg = Shard(last), Partial(), Shard(last), wp
        elif wp == Shard(n):
            xq, oq, xg, wg = Replicate(), Shard(last), Partial(), wp
        elif rows:  # each rank's w gradient sums its own rows only
            xq, oq, xg, wg = Shard(0), Shard(0), Shard(0), Partial()
        else:
            xq = oq = xg = wg = Replicate()
        xpl.append(xq)
        wpl.append(wp)
        opl.append(oq)
        xgrad.append(xg)
        wgrad.append(wg)
    layout = (mesh, tuple(xpl), tuple(wpl), tuple(opl), tuple(xgrad), tuple(wgrad))
    if any(_spans(mesh, pl) for pl in layout[3:]):
        return _BlockProduct.apply(x, w, layout)
    xl, wl = to_block(x, xpl, xgrad), to_block(w, wpl, wgrad)
    out = from_block(torch.matmul(xl, wl), mesh, opl, (*x.shape[:-1], w.shape[-1]))
    return out.redistribute(mesh, _whole(opl)) if _whole(opl) != tuple(opl) else out


def _whole(placements) -> tuple:
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Replicate() if isinstance(p, Partial) else p for p in placements)


def _spans(mesh, placements) -> bool:
    """Whether a block laid out by ``placements`` is a partial sum over more
    than one rank."""
    from torch.distributed.tensor import Partial

    return any(isinstance(p, Partial) and mesh.size(i) > 1 for i, p in enumerate(placements))


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D ``a`` and ``b`` (one dtype), summed and returned in
    f32: the products of bf16 values are exact in f32, and the card's bf16
    GEMM writes its f32 sums out as they are."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()  # torch has no bf16 -> f32 product on the CPU


def _mm(a: torch.Tensor, b: torch.Tensor, f32: bool) -> torch.Tensor:
    return mm_f32(a, b) if f32 else a @ b


class _BlockProduct(torch.autograd.Function):
    """``weight_product`` on local blocks where a block of the result or of a
    gradient is a partial sum over ranks (a row-parallel result, the input
    gradient of a column-parallel product, an FSDP weight gradient).  Each
    such block is summed in f32 and reduced in f32, then rounded once, as one
    device rounds each whole sum once (rounded to bf16 before they were
    reduced, 4-way TP moved falcon-mamba's and zamba2's logits by 0.3 and
    zamba2's gradient leaves by 0.17 of their magnitude).  A weight whole on
    a mesh dim keeps its gradient a partial sum there, reduced once a leaf
    after the backward, in the leaf's dtype (the data-parallel sync).  Every
    other block is the product one device computes, in the operands' dtype.
    ``layout``: (mesh, x's, w's and the result's block placements, x's and
    w's gradient block placements), as ``weight_product`` lays them out."""

    @staticmethod
    def forward(ctx, x, w, layout):
        mesh, xpl, wpl, opl, _, _ = layout
        xl = with_placements(x, mesh, xpl).to_local()
        wl = with_placements(w, mesh, wpl).to_local()
        ctx.save_for_backward(xl, wl)
        ctx.layout = layout
        ctx.inputs = ((x.placements, x.shape, x.dtype), (w.placements, w.shape, w.dtype))
        out = _mm(xl.reshape(-1, xl.shape[-1]), wl, _spans(mesh, opl))
        out = from_block(out.reshape(*xl.shape[:-1], -1), mesh, opl, (*x.shape[:-1], w.shape[-1]))
        return out.redistribute(mesh, _whole(opl)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate

        xl, wl = ctx.saved_tensors
        mesh, _, _, opl, xgrad, wgrad = ctx.layout
        (xp, xshape, xdtype), (wp, wshape, wdtype) = ctx.inputs
        gl = with_placements(g, mesh, _whole(opl)).to_local().to(xl.dtype)
        gl = gl.reshape(-1, gl.shape[-1])
        gx = _mm(gl, wl.transpose(0, 1), _spans(mesh, xgrad)).reshape(xl.shape)
        gw = _mm(xl.reshape(-1, xl.shape[-1]).transpose(0, 1), gl, _spans(mesh, wgrad))
        # a weight whole on a mesh dim keeps its gradient partial there (the
        # leaf's one data-parallel sync reduces it); x takes its gradient
        # whole where it is a partial sum itself, as DTensor's own
        # redistribution gives it
        wkeep = tuple(q if isinstance(q, Partial) and p == Replicate() else p
                      for q, p in zip(wgrad, wp))
        return (_grad(gx, mesh, xgrad, _whole(xp), xshape, xdtype),
                _grad(gw, mesh, wgrad, wkeep, wshape, wdtype), None)


def _grad(block, mesh, placements, target, shape, dtype) -> torch.Tensor:
    """The gradient whose block here is ``block`` (laid out by
    ``placements``), redistributed to ``target``, then cast to ``dtype``."""
    grad = from_block(block, mesh, placements, shape).redistribute(mesh, target)
    return from_block(grad.to_local().to(dtype), mesh, target, shape)


def is_sharded(x: torch.Tensor, dim: int) -> bool:
    """Whether the DTensor ``x`` is split along ``dim`` by some mesh dim."""
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def local_slice(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``placements``
    (mesh dims in order, each splitting its tensor dim evenly)."""
    from torch.distributed.tensor import Shard

    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            x = x.tensor_split(n, dim=p.dim)[mesh.get_local_rank(i)]
    return x


def place_as(x: torch.Tensor, mesh, placements):
    """The global tensor ``x`` (the same on every rank) as a DTensor with
    ``placements`` on ``mesh``: each rank keeps a copy of only its own block,
    so the global tensor can be released."""
    local = local_slice(x, mesh, placements).clone(memory_format=torch.contiguous_format)
    return from_block(local, mesh, placements, x.shape)


def place(x: torch.Tensor, sharding: NamedSharding):
    """``x`` laid out by ``sharding`` (see :func:`place_as`)."""
    return place_as(x, sharding.mesh, sharding.placements)


def place_tree(tree: Any, shardings: Any) -> Any:
    return nn.tree_map(place, tree, shardings)


def to_global(x: torch.Tensor) -> torch.Tensor:
    """A plain tensor holding the whole of ``x``: a DTensor is gathered (a
    collective every rank of its mesh enters), anything else returned."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def activate(mesh, rules: Dict[str, MeshAxes]) -> None:
    """Install rules so ``nn.logical_constraint`` redistributes DTensors."""
    nn.set_logical_rules(mesh, rules)


def deactivate() -> None:
    nn.clear_logical_rules()
