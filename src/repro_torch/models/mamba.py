"""Selective state-space blocks: Mamba1 (falcon-mamba-7b) and Mamba2 (the
zamba2-1.2b backbone), the port of ``repro.models.mamba``.

The JAX module runs the sequence through a chunked selective scan: the
discretised transition and input terms (da, dbx), the big (B, c, d_inner,
d_state) tensors, exist only per chunk of ``SCAN_CHUNK`` steps, the
recurrence h_t = a_t·h_{t-1} + b_t runs inside a chunk as an associative
scan, and chunks carry the boundary state in order.  The port keeps that
skeleton (:func:`run_chunked_scan`, :func:`intra_chunk_scan`) in plain tensor
ops, which autograd differentiates: it is the training path of both
families and Mamba2's serving path.  Torch has no ``associative_scan``, so
the inclusive scan is Hillis-Steele doubling with JAX's combine; it sums in
another order than ``lax.associative_scan``'s tree, which costs a few f32
ulps of each state (``tests/test_torch_ssm_train.py`` states the limit).

Mamba1 serving runs kernel K4 (``kernels.mamba_scan``) instead, which
computes the scan's recurrence part over the whole sequence: the gates are
computed over the whole sequence first, and the D-skip and the gating are
added here, as the JAX chunk body adds them.  K4 is forward-only, as the
Pallas kernel is, so training never reaches it.  Decode advances the
recurrence one token with plain tensor ops, as JAX does.

Roundings follow JAX under ``jit``: activations in bf16, the dt projection
with bf16 operands and an f32 result (XLA folds ``einsum(bf16).astype(f32)``
into one f32-result dot), the scan in f32, y rounded to bf16 before the
``silu(z)`` gate, and the gated result to bf16.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import selective_scan
from repro_torch.models import nn
from repro_torch.models.nn import ParamSpec, logical_constraint

SCAN_CHUNK = 256


# --------------------------------------------------------------------------
# chunk-scan skeleton
# --------------------------------------------------------------------------


def _assoc_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of (a, b) pairs under :func:`_assoc_combine` along
    axis 1, by Hillis-Steele doubling: log2(c) rounds, each combining every
    element with the one ``d`` steps before it."""
    c, d = a.shape[1], 1
    while d < c:
        a_new, b_new = _assoc_combine((a[:, :-d], b[:, :-d]), (a[:, d:], b[:, d:]))
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
        d *= 2
    return a, b


def run_chunked_scan(seq_inputs: Any, h0: torch.Tensor, chunk: int, body_fn: Callable):
    """``seq_inputs``: a (B, S, ...) tensor or a tuple of them; ``body_fn``:
    (h_in, chunk_inputs) -> (h_out, y_chunk (B, c, ...)).  -> (y, h_last)."""
    leaves = seq_inputs if isinstance(seq_inputs, tuple) else (seq_inputs,)
    s = leaves[0].shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # irregular smoke-test lengths: single chunk
    h, ys = h0, []
    for i in range(0, s, chunk):
        part = tuple(x[:, i:i + chunk] for x in leaves)
        h, y = body_fn(h, part if isinstance(seq_inputs, tuple) else part[0])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def intra_chunk_scan(da: torch.Tensor, dbx: torch.Tensor, h_in: torch.Tensor):
    """da, dbx: (B, c, ...state); h_in: (B, ...state) -> (h_all, h_last)."""
    a_cum, b_cum = _inclusive_scan(da, dbx)
    h_all = b_cum + a_cum * h_in[:, None]
    return h_all, h_all[:, -1]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via k shifted adds. x: (B, S, C), w: (C, k).
    A DTensor ``x`` is convolved on each rank's batch rows and channels."""
    if nn.is_dtensor(x):
        return _causal_conv_sharded(x, w, b)
    k = w.shape[1]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    for j in range(k):
        out = out + xp[:, j:j + s, :] * w[:, j].to(x.dtype)
    return out + b.to(x.dtype)


def _causal_conv_sharded(x, w, b):
    """``causal_conv`` on local blocks: x keeps its batch and channel shards
    and gathers its positions, w and b take x's channel shards; their
    gradients are partial sums over the mesh dims that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.runtime.sharding import from_block, with_placements

    mesh = x.device_mesh
    xpl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                for p in x.placements)
    wpl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xpl)
    gpl = tuple(Partial() if p == Shard(0) else q for p, q in zip(xpl, wpl))
    xl = with_placements(x, mesh, xpl).to_local()
    wl, bl = (with_placements(t, mesh, wpl).to_local(grad_placements=gpl) for t in (w, b))
    out = causal_conv(xl, wl, bl)
    return from_block(out, mesh, xpl, x.shape)


def causal_conv_step(x_t: torch.Tensor, tail: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One-token conv. x_t: (B, C); tail: (B, k-1, C) previous raw inputs."""
    window = torch.cat([tail, x_t[:, None, :]], dim=1)  # (B, k, C)
    out = torch.einsum("bkc,ck->bc", window, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return out, window[:, 1:, :]


def _conv_tail(x_raw: torch.Tensor, k: int) -> torch.Tensor:
    s = x_raw.shape[1]
    if s >= k - 1:
        return x_raw[:, s - (k - 1):, :].contiguous()
    return F.pad(x_raw, (0, 0, k - 1 - s, 0))


def mamba1_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, k, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank
    return {
        "ln": ParamSpec((d,), (None,), "ones"),
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((di, k), ("ssm_inner", None)),
        "conv_b": ParamSpec((di,), ("ssm_inner",), "zeros"),
        "x_proj": ParamSpec((di, r + 2 * n), ("ssm_inner", None)),
        "dt_w": ParamSpec((r, di), (None, "ssm_inner")),
        "dt_b": ParamSpec((di,), ("ssm_inner",), "dt_bias"),
        "A_log": ParamSpec((di, n), ("ssm_inner", None), "s4d"),
        "D": ParamSpec((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _mamba1_gates(cfg: ModelConfig, p, xi: torch.Tensor):
    """xi: (B, ..., di) post-conv activations -> dt, B, C (f32)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = nn.dense(xi, p["x_proj"])
    dt_low, bb, cc = torch.split(proj, [r, n, n], dim=-1)
    dt = nn.dense(dt_low, p["dt_w"])
    dt = F.softplus(dt.to(torch.float32) + p["dt_b"].to(torch.float32))
    return dt, bb.to(torch.float32), cc.to(torch.float32)


def mamba1_forward(cfg: ModelConfig, p, x: torch.Tensor, *, make_cache: bool = False,
                   training: bool = False):
    """x: (B, S, d) -> (y, cache | None).  Serving runs the scan through K4;
    ``training`` runs JAX's chunk body under :func:`run_chunked_scan`, with
    each chunk recomputed in backward: at falcon's width one (B, c, d_inner,
    N) f32 tensor is 134 MB a sequence, and a chunk's scan keeps ~20 of them
    for autograd.  Recomputation changes no value."""
    h = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    xz = nn.dense(h, p["in_proj"])
    xi, z = xz.chunk(2, dim=-1)
    xi = logical_constraint(xi, "act_batch", None, "ssm_inner")
    xc = nn.silu(causal_conv(xi, p["conv_w"], p["conv_b"])).contiguous()

    A = -torch.exp(p["A_log"].to(torch.float32))  # (di, n)
    d_skip = p["D"].to(torch.float32)
    if training:
        def body(h_in, xc_c):
            dt, bb, cc = _mamba1_gates(cfg, p, xc_c)  # (B, c, di|n)
            da = torch.exp(dt[..., None] * A)  # (B, c, di, n)
            dbx = (dt * xc_c.to(torch.float32))[..., None] * bb[:, :, None, :]
            h_all, h_out = intra_chunk_scan(da, dbx, h_in)
            y = torch.einsum("bscn,bsn->bsc", h_all, cc)
            y = y + d_skip * xc_c.to(torch.float32)
            return h_out, y.to(x.dtype)

        h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
        y, h_last = run_chunked_scan(
            xc, h0, SCAN_CHUNK, functools.partial(checkpoint, body, use_reentrant=False))
    else:
        dt, bb, cc = _mamba1_gates(cfg, p, xc)
        y, h_last = selective_scan(dt.contiguous(), A.contiguous(), bb.contiguous(),
                                   cc.contiguous(), xc)
        y = (y + d_skip * xc.to(torch.float32)).to(x.dtype)
    y = (y.to(torch.float32) * nn.silu(z.to(torch.float32))).to(x.dtype)
    out = nn.dense(y, p["out_proj"])

    cache = None
    if make_cache:
        cache = {"state": h_last, "conv": _conv_tail(xi, cfg.ssm_conv)}
    return x + out, cache


def mamba1_decode(cfg: ModelConfig, p, x: torch.Tensor, cache):
    """x: (B, 1, d); cache {state: (B, di, n) f32, conv: (B, k-1, di)}."""
    p = nn.gather_fsdp(p)
    h = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    xz = nn.dense(h, p["in_proj"])
    xi, z = xz[:, 0].chunk(2, dim=-1)  # (B, di)
    xc, new_tail = causal_conv_step(xi, cache["conv"], p["conv_w"], p["conv_b"])
    xc = nn.silu(xc)
    dt, bb, cc = _mamba1_gates(cfg, p, xc)
    A = -torch.exp(p["A_log"].to(torch.float32))
    da = torch.exp(dt[..., None] * A)  # (B, di, n)
    dbx = (dt * xc.to(torch.float32))[..., None] * bb[:, None, :]
    hst = da * cache["state"] + dbx
    y = torch.einsum("bcn,bn->bc", hst, cc) + p["D"].to(torch.float32) * xc.to(torch.float32)
    y = (y * nn.silu(z.to(torch.float32))).to(x.dtype)
    out = nn.dense(y, p["out_proj"])[:, None]
    return x + out, {"state": hst, "conv": new_tail}


def mamba1_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    return {
        "state": ParamSpec((batch, cfg.d_inner, cfg.ssm_state), ("act_batch", "ssm_inner", None)),
        "conv": ParamSpec((batch, cfg.ssm_conv - 1, cfg.d_inner), ("act_batch", None, "ssm_inner")),
    }


# --------------------------------------------------------------------------
# Mamba2 (zamba2 backbone)
# --------------------------------------------------------------------------


def mamba2_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh = cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "ln": ParamSpec((d,), (None,), "ones"),
        "in_proj": ParamSpec((d, 2 * di + 2 * n + nh), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((conv_dim, k), ("ssm_inner", None)),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), "s4d"),
        "D": ParamSpec((nh,), ("ssm_heads",), "ones"),
        "dt_b": ParamSpec((nh,), ("ssm_heads",), "dt_bias"),
        "norm": ParamSpec((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def mamba2_forward(cfg: ModelConfig, p, x: torch.Tensor, *, make_cache: bool = False):
    """x: (B, S, d) -> (y, cache | None), through the elementwise chunk body
    (``ssm_algo="scan"``) or the SSD matmul form (``"ssd"``, zamba2's), as
    JAX picks."""
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    h = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = nn.dense(h, p["in_proj"])
    z, xbc_raw, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc = nn.silu(causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xi, bb, cc = torch.split(xbc, [di, n, n], dim=-1)
    xi = logical_constraint(xi, "act_batch", None, "ssm_inner")

    A = -torch.exp(p["A_log"].to(torch.float32))  # (H,)
    y, h_last = mamba2_scan(cfg, xi, bb, cc, dt_raw, A, p["D"].to(torch.float32),
                            p["dt_b"].to(torch.float32))
    y = nn.rms_norm(
        (y.to(torch.float32) * nn.silu(z.to(torch.float32))).to(x.dtype), p["norm"], cfg.norm_eps
    )
    out = nn.dense(y, p["out_proj"])

    cache = None
    if make_cache:
        cache = {"state": h_last, "conv": _conv_tail(xbc_raw, cfg.ssm_conv)}
    return x + out, cache


def mamba2_scan(cfg: ModelConfig, xi, bb, cc, dt_raw, A, d_skip, dt_b):
    """Mamba2's recurrence over the whole sequence: xi (B, S, H·P), bb, cc
    (B, S, N), dt_raw (B, S, H), and A, D, dt bias (H,) f32 -> (y (B, S,
    H·P) in xi's dtype, h_last (B, H, P, N) f32), through the elementwise
    chunk body (``ssm_algo="scan"``) or the SSD matmul form (``"ssd"``,
    zamba2's), as JAX picks.  DTensors run on each rank's batch rows and
    SSM heads (:func:`_mamba2_scan_sharded`)."""
    if nn.is_dtensor(xi):
        return _mamba2_scan_sharded(cfg, xi, bb, cc, dt_raw, A, d_skip, dt_b)
    bsz, nh, hp, n = xi.shape[0], A.shape[0], cfg.ssm_head_dim, bb.shape[-1]
    di = nh * hp

    def body_scan(h_in, inputs):
        """The elementwise associative scan over (B, c, H, P, N) states."""
        xi_c, bb_c, cc_c, dtr_c = inputs  # (B, c, ...)
        c = xi_c.shape[1]
        dt = F.softplus(dtr_c.to(torch.float32) + dt_b)
        da = torch.exp(dt * A)  # (B, c, H)
        xh = xi_c.reshape(bsz, c, nh, hp).to(torch.float32)
        dbx = (dt[..., None] * xh)[..., None] * bb_c.to(torch.float32)[:, :, None, None, :]
        h_all, h_out = intra_chunk_scan(da[..., None, None].expand(dbx.shape), dbx, h_in)
        y = torch.einsum("bshpn,bsn->bshp", h_all, cc_c.to(torch.float32))
        y = y + d_skip[:, None] * xh
        return h_out, y.reshape(bsz, c, di).to(xi.dtype)

    def body_ssd(h_in, inputs):
        """The SSD (matmul) form of the same recurrence: (B, c, c, H)
        attention-like matrices instead of (B, c, H, P, N) states.  JAX takes
        ``exp`` of every (i, j) log-decay and masks j > i after it; there the
        decay can overflow to inf, and the gradient of the masked inf is
        0·inf = NaN.  The port masks before ``exp`` (exp(-inf) = 0), which
        gives the same values and a finite gradient."""
        xi_c, bb_c, cc_c, dtr_c = inputs
        c = xi_c.shape[1]
        dt = F.softplus(dtr_c.to(torch.float32) + dt_b)
        da = dt * A  # (B, c, H), negative
        cs = torch.cumsum(da, dim=1)  # inclusive log-decay prefix
        xh = xi_c.reshape(bsz, c, nh, hp).to(torch.float32)
        bbf, ccf = bb_c.to(torch.float32), cc_c.to(torch.float32)
        # intra-chunk: y_i += sum_{j<=i} exp(cs_i - cs_j) dt_j (C_i.B_j) x_j
        diff = cs[:, :, None, :] - cs[:, None, :, :]  # (B, c, c, H), <= 0 on tril
        tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xi.device))
        L = torch.exp(diff.masked_fill(~tril[None, :, :, None], float("-inf")))
        L = L * dt[:, None, :, :]  # decay * dt_j
        G = torch.einsum("bin,bjn->bij", ccf, bbf)  # (B, c, c) C_i . B_j
        M = G[..., None] * L  # (B, c, c, H)
        y = torch.einsum("bijh,bjhp->bihp", M, xh)
        # inter-chunk: y_i += exp(cs_i) C_i . h_in
        y = y + torch.exp(cs)[..., None] * torch.einsum("bin,bhpn->bihp", ccf, h_in)
        y = y + d_skip[:, None] * xh
        # carry: h_out = exp(cs_last) h_in + sum_j exp(cs_last - cs_j) b_j
        decay_end = torch.exp(cs[:, -1:, :] - cs) * dt  # (B, c, H)
        h_out = torch.exp(cs[:, -1, :])[..., None, None] * h_in + torch.einsum(
            "bch,bchp,bcn->bhpn", decay_end, xh, bbf)
        return h_out, y.reshape(bsz, c, di).to(xi.dtype)

    body = body_ssd if cfg.ssm_algo == "ssd" else body_scan
    chunk = SCAN_CHUNK if cfg.ssm_algo == "ssd" else SCAN_CHUNK // 4
    h0 = torch.zeros((bsz, nh, hp, n), dtype=torch.float32, device=xi.device)
    return run_chunked_scan((xi, bb, cc, dt_raw), h0, chunk, body)


def _mamba2_scan_sharded(cfg: ModelConfig, xi, bb, cc, dt_raw, A, d_skip, dt_b):
    """:func:`mamba2_scan` on local blocks: batch rows where xi's rows are
    split, SSM heads over the mesh dims that split xi's channels where the
    heads divide (whole elsewhere), B and C whole over the heads; their
    gradients, and those of A, D and the dt bias, are partial sums over the
    mesh dims that split the other operand."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.runtime.sharding import from_block, to_block

    mesh, nh = xi.device_mesh, A.shape[0]
    rows = [p == Shard(0) for p in xi.placements]
    split = [p == Shard(2) for p in xi.placements]
    ways = 1
    for i, s in enumerate(split):
        ways *= mesh.size(i) if s else 1
    heads = split if nh % ways == 0 else [False] * mesh.ndim
    R = Replicate()
    xpl = [Shard(0) if r else Shard(2) if h else R for r, h in zip(rows, heads)]
    bpl = [Shard(0) if r else R for r in rows]
    bgrad = [Shard(0) if r else Partial() if h else R for r, h in zip(rows, heads)]
    apl = [Shard(0) if h else R for h in heads]
    agrad = [Partial() if r else q for r, q in zip(rows, apl)]
    y, h_last = mamba2_scan(
        cfg, to_block(xi, xpl), to_block(bb, bpl, bgrad), to_block(cc, bpl, bgrad),
        to_block(dt_raw, xpl), *(to_block(t, apl, agrad) for t in (A, d_skip, dt_b)))
    hpl = [Shard(1) if q == Shard(2) else q for q in xpl]
    return (from_block(y, mesh, xpl, xi.shape),
            from_block(h_last, mesh, hpl, (xi.shape[0], nh, cfg.ssm_head_dim, bb.shape[-1])))


def mamba2_decode(cfg: ModelConfig, p, x: torch.Tensor, cache):
    """x: (B, 1, d); cache {state: (B, H, P, N) f32, conv: (B, k-1, conv_dim)}."""
    bsz = x.shape[0]
    di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = nn.dense(h, p["in_proj"])[:, 0]
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc_c, new_tail = causal_conv_step(xbc, cache["conv"], p["conv_w"], p["conv_b"])
    xbc_c = nn.silu(xbc_c)
    xi, bb, cc = torch.split(xbc_c, [di, n, n], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_b"].to(torch.float32))  # (B, H)
    A = -torch.exp(p["A_log"].to(torch.float32))
    da = torch.exp(dt * A)  # (B, H)
    xh = xi.reshape(bsz, nh, hp).to(torch.float32)
    dbx = (dt[..., None] * xh)[..., None] * bb.to(torch.float32)[:, None, None, :]
    hst = da[..., None, None] * cache["state"] + dbx
    y = torch.einsum("bhpn,bn->bhp", hst, cc.to(torch.float32))
    y = y + p["D"].to(torch.float32)[:, None] * xh
    y = y.reshape(bsz, di)
    y = nn.rms_norm(
        (y * nn.silu(z.to(torch.float32))).to(x.dtype), p["norm"], cfg.norm_eps
    )
    out = nn.dense(y, p["out_proj"])[:, None]
    return x + out, {"state": hst, "conv": new_tail}


def mamba2_cache_specs(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "state": ParamSpec(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            ("act_batch", "ssm_heads", None, None),
        ),
        "conv": ParamSpec((batch, cfg.ssm_conv - 1, conv_dim), ("act_batch", None, "ssm_inner")),
    }
