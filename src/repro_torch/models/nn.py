"""Shared NN machinery (port of ``repro.models.nn``): parameter specs, norms,
rotary embeddings, and the memory-bounded chunked attention.

Parameters are plain nested dicts of tensors with the same keys and shapes as
the JAX ``ParamSpec`` trees, layers stacked on axis 0, so JAX-initialised
parameters load directly (``repro_torch.convert``).  Initial draws come from a
``torch.Generator`` and differ from ``jax.random``'s; parity tests load the
JAX-initialised parameters and never compare inits.
"""
from __future__ import annotations

import functools
import math
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
    """1/(1 + exp(-x)) with each op rounded to bf16, in place after the neg."""
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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, w_gate.to(x.dtype))
    u = torch.matmul(x, w_up.to(x.dtype))
    return torch.matmul(silu(g) * u, w_down.to(x.dtype))


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
    cos are taken in f64 and rounded.  On the CPU numpy takes them: torch's
    multithreaded f64 sin there rounds some rows differently from one
    process to the next."""
    dev = torch.device("cpu" if device is None else device)
    inv = np.reciprocal(np.power(10_000.0, np.arange(0, d_model, 2) / d_model).astype(np.float32))
    pos = (torch.arange(seq_len, device=dev) + offset).to(torch.float32)[:, None]
    ang = (pos * torch.from_numpy(inv).to(dev)).to(torch.float64)
    if dev.type == "cpu":
        sin, cos = torch.from_numpy(np.sin(ang.numpy())), torch.from_numpy(np.cos(ang.numpy()))
    else:
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
    / partially-filled caches).
    """
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


def logical_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Sharding annotation: the identity until the port shards (ROADMAP item
    "Sharding")."""
    return x
