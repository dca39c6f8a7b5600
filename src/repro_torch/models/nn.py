"""Shared NN machinery (port of ``repro.models.nn``): parameter specs, norms,
rotary embeddings, and the memory-bounded chunked attention.

Parameters are plain nested dicts of tensors with the same keys and shapes as
the JAX ``ParamSpec`` trees, layers stacked on axis 0, so JAX-initialised
parameters load directly (``repro_torch.convert``).  Initial draws come from a
``torch.Generator`` and differ from ``jax.random``'s; parity tests load the
JAX-initialised parameters and never compare inits.
"""
from __future__ import annotations

import contextlib
import functools
import math
import sys
from typing import TYPE_CHECKING, Any, Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

if TYPE_CHECKING:
    from repro_torch.configs.base import ModelConfig

PyTree = Any
NEG_INF = -1e30


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (None = replicated dim)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier for "normal"

    def with_prefix(self, n: int, axis_name: str = "layers") -> "ParamSpec":
        return ParamSpec((n,) + self.shape, (axis_name,) + self.axes, self.init, self.scale)


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """Map over the leaves of a nested dict (tensors, arrays or specs); with
    ``rest``, ``fn`` takes the leaf at the same path of every tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


spec_tree_map = tree_map  # the JAX package's name: spec trees are nested dicts too


def tree_leaves(tree: PyTree) -> list:
    """Leaves in sorted-key order, as ``jax.tree.leaves`` gives them."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: PyTree, leaves: list) -> PyTree:
    """The tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def stack_specs(specs: PyTree, n: int) -> PyTree:
    """Prepend a stacked ``layers`` dimension to every spec in the tree."""
    return spec_tree_map(lambda s: s.with_prefix(n), specs)


def init_params(specs: PyTree, generator: torch.Generator, device: torch.device,
                dtype: torch.dtype = torch.float32,
                then: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> PyTree:
    """Materialize parameters: normal(0, scale / sqrt(fan_in)), ones/zeros, or
    the SSM inits (``s4d``: log(1..N) along the last dim; ``dt_bias``: the
    softplus inverse of dt ~ U[1e-3, 1e-1]).  ``generator`` must live on
    ``device``.  ``then``, if given, maps each leaf as soon as it is drawn
    (the drawn leaf is released after it), so the tree of drawn leaves never
    exists whole."""

    def one(s: ParamSpec) -> torch.Tensor:
        x = draw(s)
        return x if then is None else then(x)

    def draw(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        if s.init == "s4d":
            row = torch.log(torch.arange(1, s.shape[-1] + 1, dtype=torch.float32, device=device))
            return row.expand(s.shape).to(dtype).contiguous()
        if s.init == "dt_bias":
            u = torch.rand(s.shape, generator=generator, dtype=torch.float32, device=device)
            u = u.mul_(1e-1 - 1e-3).add_(1e-3)
            return torch.log(torch.expm1(u)).to(dtype)
        if s.init != "normal":
            raise ValueError(f"unknown init {s.init!r}")
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(std).to(dtype)

    return spec_tree_map(one, specs)


def fake_mode():
    """The active ``FakeTensorMode``, or a new one.  Tensors of two modes do
    not mix: make every fake tensor of one run inside one mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    return mode if mode is not None else FakeTensorMode()


def abstract_params(specs: PyTree, dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda") -> PyTree:
    """Fake tensors of the specs' shapes in ``dtype`` on ``device`` (JAX's
    ``ShapeDtypeStruct``s): shapes and dtypes, no storage, no device memory."""
    with fake_mode():
        return spec_tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device=device), specs)


def param_count(specs: PyTree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree."""
    return tree_map(lambda a: a[i], tree)


def unstack(tree) -> List[Any]:
    """The per-layer trees of a stacked tree, as views.  ``unbind``'s
    backward stacks the layers' gradients once, where indexing each layer
    would add a zero-filled gradient of the whole stack per layer."""
    flat = [torch.unbind(a, 0) for a in tree_leaves(tree)]
    return [tree_unflatten(tree, list(one)) for one in zip(*flat)]


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's ``checkpoint_dots_with_no_batch_dims``: keep the weight products
    (``aten.mm``), recompute the rest (attention's batched products too)."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, cfg: "ModelConfig", training: bool):
    """Port of JAX's ``_remat``, for every family's layers: ``"full"``
    recomputes the whole layer in backward, ``"dots"`` all but its weight
    products, ``"nothing"`` keeps everything.  Recomputation gives the same
    values bit for bit."""
    if not training or cfg.remat == "nothing":
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return functools.partial(checkpoint, fn, **kw)


# --------------------------------------------------------------------------
# basic ops
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


def _logistic_bf16(x: torch.Tensor) -> torch.Tensor:
    """1/(1 + exp(-x)) with each op rounded to bf16, in place after the neg
    (out of place on a DTensor, whose partial sums an in-place op cannot
    reduce)."""
    if is_dtensor(x):
        return torch.reciprocal(torch.exp(torch.neg(x)) + 1)
    return torch.neg(x).exp_().add_(1).reciprocal_()


class _LogisticBf16(torch.autograd.Function):
    """The bf16 logistic with JAX's jvp, ``g * (y * (1 - y))``, as its
    backward.  Differentiating 1/(1 + exp(-x)) op by op would give
    0 * inf = NaN wherever exp(-x) overflows (x < -88.7)."""

    @staticmethod
    def forward(ctx, x):
        y = _logistic_bf16(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``jax.nn.sigmoid`` as XLA evaluates it: on bf16, 1/(1 + exp(-x))
    with each op rounded to bf16, which misses the correctly rounded sigmoid
    by an ulp on 1106 of the 33860 zero or normal bf16 inputs with |x| <= 80
    and equals XLA's on all of them, once XLA's flush of subnormal results
    is applied (``tests/test_torch_models.py``); in f32, the correctly
    rounded value.  Both differentiate as JAX's ``logistic`` does."""
    if x.dtype == torch.bfloat16:
        return _LogisticBf16.apply(x)
    return torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The weight product ``x @ w``: x (..., K), w (K, N) cast to x's dtype.
    On a mesh (a DTensor operand) it runs on each rank's local blocks, laid
    out by the weight's own placements as JAX's rules lay out a weight
    product (``runtime.sharding.weight_product``): the activations keep only
    their batch shards, a column-parallel product leaves its result split
    over ``model`` on the last dim, a row-parallel one reduces its partial
    sums to whole rows.  DTensor's own propagation would carry a partial sum
    into the next norm and split rows over ``model`` where JAX never does,
    which later products and reshapes cannot take."""
    w = w.to(x.dtype)
    if is_dtensor(x) or is_dtensor(w):
        from repro_torch.runtime.sharding import weight_product

        return weight_product(x, w)
    return torch.matmul(x, w)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(silu(g) * u, w_down)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, d_model: int, offset: int = 0, device=None) -> torch.Tensor:
    """(seq_len, d_model) f32 table: sin at even, cos at odd columns, of
    (position + offset) / 10000^(2i / d_model); ``offset`` is decode's write
    position.  The division is a product with the f32 reciprocal of the
    correctly rounded power, as XLA compiles JAX's under jit (dividing moves
    an angle by an ulp: up to 1.2e-4 in sin/cos near position 2048); sin and
    cos are taken in f64 and rounded.  On the CPU numpy builds the whole
    table: torch's multithreaded f64 sin there rounds some rows differently
    from one process to the next.  Under a ``FakeTensorMode`` (a dry run)
    torch builds it on ``device``, as on the card: only its shape is read."""
    dev = torch.device("cpu" if device is None else device)
    inv = np.reciprocal(np.power(10_000.0, np.arange(0, d_model, 2) / d_model).astype(np.float32))
    faking = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
    if dev.type == "cpu" and not faking:
        ang = ((np.arange(seq_len) + offset).astype(np.float32)[:, None] * inv).astype(np.float64)
        table = np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(seq_len, d_model)
        return torch.from_numpy(table.astype(np.float32))
    pos = (torch.arange(seq_len, device=dev) + offset).to(torch.float32)[:, None]
    ang = (pos * torch.from_numpy(inv).to(dev)).to(torch.float64)
    sin, cos = torch.sin(ang), torch.cos(ang)
    return torch.stack([sin, cos], dim=-1).reshape(seq_len, d_model).to(torch.float32)


# --------------------------------------------------------------------------
# attention — memory-bounded chunked softmax attention (port of the XLA
# path).  Prefill goes through the flash kernel (kernels/flash_attention);
# this version serves training, whose gradients flow through it as in JAX
# (the kernel is forward-only), and the decode step over a part-filled cache
# (kv_len).
# --------------------------------------------------------------------------


def attention(
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Skv, KVH, Dh)
    v: torch.Tensor,  # (B, Skv, KVH, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked attention. Peak memory O(B*H*chunk*Skv) instead of O(B*H*Sq*Skv).

    ``q_offset``: absolute position of q[:, 0] (decode: the write position).
    ``kv_len``: if given, keys at positions >= kv_len are masked (ring buffers
    / partially-filled caches).  DTensors attend on each rank's batch rows
    and q heads (``runtime.sharding.head_shards``), unless the keys are split
    over their positions (a decode cache on ``kv_seq``): then q is whole over
    its heads, as the cache rules' decode layout has it, and DTensor's
    products split the scores over the keys' positions.
    """
    if is_dtensor(q):
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch.runtime.sharding import head_shards, is_sharded, with_placements

        if not is_sharded(k, 1):
            ql, kl, vl, wrap = head_shards(q, k, v)
            return wrap(attention(ql, kl, vl, causal=causal, window=window, chunk=chunk,
                                  q_offset=q_offset, kv_len=kv_len, scale=scale))
        q = with_placements(q, q.device_mesh,
                            tuple(p if p == Shard(0) else Replicate() for p in q.placements))
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    kv_pos = torch.arange(skv, device=q.device)

    if sq <= chunk:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        return _attn_chunk_masked(
            q, k, v, q_pos, kv_pos, causal=causal, window=window, scale=scale, kv_len=kv_len
        )

    if sq % chunk:
        raise ValueError(f"seq {sq} % attn chunk {chunk}")
    outs = []
    for i in range(sq // chunk):
        q_pos = i * chunk + torch.arange(chunk, device=q.device) + q_offset
        outs.append(_attn_chunk_masked(
            q[:, i * chunk:(i + 1) * chunk], k, v, q_pos, kv_pos,
            causal=causal, window=window, scale=scale, kv_len=kv_len,
        ))
    return torch.cat(outs, dim=1)


def repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, H, D)."""
    kvh = k.shape[2]
    if kvh == h:
        return k
    return torch.repeat_interleave(k, h // kvh, dim=2)


def _attn_chunk_masked(q, k, v, q_pos, kv_pos, *, causal, window, scale, kv_len):
    h = q.shape[2]
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    # bf16 x bf16 products are exact in f32: upcasting first is XLA's
    # preferred_element_type=f32 accumulation
    scores = torch.einsum("bchd,bshd->bchs", q.to(torch.float32), k.to(torch.float32))
    scores = scores * scale
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask &= (kv_pos < kv_len)[None, :]
    scores = scores.masked_fill(~mask[None, :, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bchs,bshd->bchd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# logical sharding annotations (runtime/sharding.py installs the rules)
# --------------------------------------------------------------------------

_MESH = None
_LOGICAL_RULES: dict = {}


def set_logical_rules(mesh, rules: dict) -> None:
    global _MESH, _LOGICAL_RULES
    _MESH, _LOGICAL_RULES = mesh, dict(rules)


def clear_logical_rules() -> None:
    global _MESH, _LOGICAL_RULES
    _MESH, _LOGICAL_RULES = None, {}


def mesh_context():
    """While rules are active, plain tensors meeting DTensors in an op (masks,
    positions, tables built in the model) count as replicated on the mesh."""
    if _MESH is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing ``torch.distributed.tensor``
    (seconds on a first call, which a one-device run would pay inside its
    first timed step): no DTensor exists before that module is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def gather_fsdp(tree: PyTree) -> PyTree:
    """Each DTensor leaf gathered over the mesh axes other than ``model``
    (FSDP's all-gather of a layer's weights before use; its backward
    reduce-scatters the gradient); the TP shards stay.  Plain leaves pass."""

    def one(w):
        if not is_dtensor(w):
            return w
        from torch.distributed.tensor import Replicate

        names = w.device_mesh.mesh_dim_names
        pl = tuple(p if names[i] == "model" else Replicate() for i, p in enumerate(w.placements))
        return w if pl == tuple(w.placements) else w.redistribute(w.device_mesh, pl)

    return tree_map(one, tree)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A DTensor table is looked up on each rank's block:
    the rank's rows of ``ids`` (batch-sharded as they come) against its
    rows of the table (vocab-sharded over ``model``, whole elsewhere); ids
    outside the block give zeros, and the partial rows sum over the mesh
    dims that split the table to the one row that holds each id, so the
    value is the same.  Its backward scatters into the local rows only."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.runtime.sharding import from_block, local_range, with_placements

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = with_placements(ids, mesh, (Replicate(),) * mesh.ndim)
    # the table keeps only its vocab shards on mesh dims the ids do not split
    tpl = tuple(p if p == Shard(0) and q == Replicate() else Replicate()
                for p, q in zip(table.placements, ids.placements))
    table = with_placements(table, mesh, tpl)
    ipl = tuple(q if q == Shard(0) else Replicate() for q in ids.placements)
    ids = with_placements(ids, mesh, ipl)
    lo, n = local_range(table, 0)
    il = ids.to_local()
    mine = (il >= lo) & (il < lo + n)
    # each rank's gradient holds its own rows' lookups: partial sums over
    # the mesh dims that split the ids
    gpl = tuple(Partial() if q == Shard(0) else p for p, q in zip(tpl, ipl))
    rows = table.to_local(grad_placements=gpl)[(il - lo).clamp(0, n - 1)]
    rows = rows * mine[..., None].to(rows.dtype)
    # backward: a gradient replicated over a Partial mesh dim stays whole on
    # every rank (DTensor keeps it so), which is each partial row's gradient
    out = tuple(Shard(0) if q == Shard(0) else (Partial() if p == Shard(0) else Replicate())
                for p, q in zip(tpl, ipl))
    return from_block(rows, mesh, out, (*ids.shape, table.shape[1]))


def split_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n * m) -> (..., n, m).  A DTensor whose last dim is split more
    ways than ``n`` divides (2 KV heads on 4 ranks) gathers that dim first:
    its shards would cut a head."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        ways = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == x.ndim - 1:
                ways *= x.device_mesh.size(i)
        if n % ways:
            pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1 else p
                       for p in x.placements)
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """(..., n, m) -> (..., n * m), the inverse of :func:`split_last`.  A
    DTensor keeps only its splits of dim 0 and of the ``n`` dim: a split of
    any other dim would become a strided split of the merged one, which no
    later product takes."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch.runtime.sharding import with_placements

        keep = (Shard(0), Shard(x.ndim - 2))
        x = with_placements(x, x.device_mesh,
                            tuple(p if p in keep else Replicate() for p in x.placements))
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def set_index(buf: torch.Tensor, dim: int, i: int, val: torch.Tensor) -> None:
    """``buf.select(dim, i).copy_(val)``: a cache write in place.  On a
    DTensor ``buf`` only the rank whose block holds index ``i`` writes, its
    own rows of ``val`` (laid out as ``buf`` without ``dim``)."""
    if not is_dtensor(buf):
        buf.select(dim, i).copy_(val)
        return
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.runtime.sharding import local_range, with_placements

    target = []
    for p in buf.placements:
        if isinstance(p, Shard) and p.dim == dim:
            p = Replicate()
        elif isinstance(p, Shard) and p.dim > dim:
            p = Shard(p.dim - 1)
        target.append(p)
    v = with_placements(val, buf.device_mesh, target).to_local()
    lo, n = local_range(buf, dim)
    if lo <= i < lo + n:
        buf.to_local().select(dim, i - lo).copy_(v)


def logical_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor ``x`` to the layout its logical ``axes`` take
    under the active rules (a mesh axis is dropped from a dim it does not
    divide); the identity with no rules active or on a plain tensor."""
    if _MESH is None or not is_dtensor(x):
        return x
    from repro_torch.runtime.sharding import placements_for, spec_for

    spec = spec_for(_MESH, _LOGICAL_RULES, axes, tuple(x.shape))
    placements = placements_for(_MESH, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(_MESH, placements)
