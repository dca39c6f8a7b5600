"""Training attention on the card, rehearsed on the CPU: the arithmetic of K3's
training instance (o and each row's log-sum-exp) and of its backward K5
(``csrc/flash_attention_bwd.cu``), emulated in plain torch tile by tile,
against autograd of ``nn.attention`` in f32; and which inputs
``gqa_attn_forward(training=True)`` sends to the kernels.

The emulation follows the kernels: 64-key tiles (128-row q tiles in the
forward, as K3), tiles wholly outside the band skipped, the mask applied to the
tiles that cross it; S = Q K^T from bf16 operands with f32 sums; the forward's
online softmax with P as bf16 hi + lo; in the backward P = exp2(S c - lse
log2(e)) recomputed from the stored lse, delta = rowsum(dO o) from the bf16 o,
dS = P (dP - delta), P and dS entering their products as bf16 hi + lo, dQ
walked over each q tile's key tiles and dK/dV over each key tile's q tiles of
every q head of its GQA group; dq, dk and dv rounded once to bf16.

Tolerances, against f32 autograd of ``nn.attention`` on the same bf16 values:
  * o: |err| <= 1e-5 + 1e-2 |ref|, one bf16 rounding of the output (hi + lo
    carries P within 2^-17, far under it), as the card holds K3;
  * dv: that, + 2^-16 (P^T |dO|): hi + lo carries each P within 2^-17 |P|,
    and a key's dV sums up to S x group terms P dO (at danube's layer, 16,384),
    whose f32 sums differ in order too; P^T |dO| is their magnitude;
  * dq and dk: |err| <= 1e-2 |ref| + 2^-8 max|ref|: beyond the output's
    rounding, delta is taken from o as stored in bf16 (the plain bf16 path
    rounds dP to bf16 in its place), which moves dS by P |d delta| and a
    row's dq or dk by up to about a bf16 ulp of the largest entry;
  * each of o, dq, dk, dv no further from the f32 reference, in relative L2,
    than autograd of ``nn.attention`` on the bf16 inputs, the path the kernels
    replace: the same work, never fewer bits;
  * lse: within 1e-5 of torch.logsumexp of the f32 scaled, masked scores.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.launch import hlo_cost
from repro_torch.models import model as M
from repro_torch.models import nn, transformer

NEG_INF = -1e30
LOG2E = 1.4426950408889634
TILE = 64  # keys (and, in K5, q rows) per tile
FWD_BQ = 128  # q rows per block of K3's forward

# (B, S, H, KVH, D, causal, window): head dims 64 and 80, groups 1 and 4,
# causal with window < S and >= S (0: the whole causal square), non-causal,
# S not a multiple of the tile
CASES = [
    (1, 200, 4, 4, 64, True, 0),
    (2, 256, 8, 2, 80, True, 96),
    (1, 333, 8, 2, 80, True, 512),
    (1, 150, 4, 1, 64, True, 40),
    (1, 130, 4, 1, 64, False, 0),
    (2, 40, 4, 2, 80, True, 16),  # shorter than a tile, window inside one
]


def _keep(qpos, kpos, sq, skv, causal, window):
    m = (qpos[:, None] < sq) & (kpos[None, :] < skv)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _scale_log2(d):
    """c = log2(e) / sqrt(D), formed in f32 as the kernels form it."""
    return torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)


def _hi_lo(x):
    """x as the tensor cores take it: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def emulate_train_forward(q, k, v, *, causal, window):
    """K3's training instance: (o bf16 (B, Sq, H, D), lse f32 (B, H, Sq))."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    heads = torch.arange(h) // (h // kvh)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float()[:, :, heads].permute(0, 2, 1, 3)
    vf = v.float()[:, :, heads].permute(0, 2, 1, 3)
    c = _scale_log2(d)
    o = torch.zeros(b, h, sq, d)
    lse = torch.zeros(b, h, sq)
    for q0 in range(0, sq, FWD_BQ):
        qt = qf[:, :, q0:q0 + FWD_BQ]
        qpos = torch.arange(q0, q0 + qt.shape[2])
        k_hi = min(skv, q0 + FWD_BQ) if causal else skv
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        m = torch.full((b, h, qt.shape[2], 1), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, qt.shape[2], d)
        for k0 in range(k_lo // TILE * TILE, k_hi, TILE):
            x = qt @ kf[:, :, k0:k0 + TILE].transpose(-1, -2)
            kpos = torch.arange(k0, k0 + x.shape[-1])
            x = x.masked_fill(~_keep(qpos, kpos, sq, skv, causal, window), NEG_INF)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            live = m_new > NEG_INF / 2
            alpha = torch.where(live, torch.exp2((m - m_new) * c), torch.zeros(()))
            arg = (x.double() * c.double() - (m_new * c).double()).float()
            p = torch.where(live, torch.exp2(arg), torch.zeros(()))
            l = l * alpha + p.sum(-1, keepdim=True)
            hi, lo = _hi_lo(p)
            vt = vf[:, :, k0:k0 + TILE]
            acc = acc * alpha + hi @ vt + lo @ vt
            m = m_new
        o[:, :, q0:q0 + FWD_BQ] = acc / torch.where(l == 0, torch.ones_like(l), l)
        l, m = l[..., 0], m[..., 0]
        lse[:, :, q0:q0 + FWD_BQ] = torch.where(
            l == 0, torch.full_like(l, math.inf), (m * c + torch.log2(l)) * math.log(2))
    return o.permute(0, 2, 1, 3).to(torch.bfloat16), lse


def emulate_k5(q, k, v, o, lse, do, *, causal, window):
    """K5: (dq, dk, dv) in bf16, by its two kernels' tile walks."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    c = _scale_log2(d)
    scale = 1.0 / math.sqrt(d)
    qf, of, dof = (t.float().permute(0, 2, 1, 3) for t in (q, o, do))  # (B, H, Sq, D)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # (B, KVH, Skv, D)
    delta = (dof * of).sum(-1)  # (B, H, Sq), from the bf16 o
    lse2 = lse * LOG2E

    def probs(s, q0, k0, row_lse2):
        """P of a (q rows x keys) score tile, masked to 0."""
        qpos = torch.arange(q0, q0 + s.shape[-2])
        kpos = torch.arange(k0, k0 + s.shape[-1])
        p = torch.exp2((s.double() * c.double() - row_lse2[..., :, None].double()).float())
        return torch.where(_keep(qpos, kpos, sq, skv, causal, window), p, torch.zeros(()))

    # the dq kernel: each q tile walks the key tiles of its band
    heads = torch.arange(h) // group
    kh, vh = kf[:, heads], vf[:, heads]
    dq = torch.zeros(b, h, sq, d)
    for q0 in range(0, sq, TILE):
        rows = slice(q0, q0 + TILE)
        k_hi = min(skv, q0 + TILE) if causal else skv
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        for k0 in range(k_lo // TILE * TILE, k_hi, TILE):
            kt, vt = kh[:, :, k0:k0 + TILE], vh[:, :, k0:k0 + TILE]
            p = probs(qf[:, :, rows] @ kt.transpose(-1, -2), q0, k0, lse2[:, :, rows])
            ds = p * (dof[:, :, rows] @ vt.transpose(-1, -2) - delta[:, :, rows, None])
            hi, lo = _hi_lo(ds)
            dq[:, :, rows] += hi @ kt + lo @ kt
    # the dk/dv kernel: each key tile walks, for each q head of its group, the
    # q tiles whose rows see it; the group's sums stay in one accumulator
    dk = torch.zeros(b, kvh, skv, d)
    dv = torch.zeros(b, kvh, skv, d)
    for k0 in range(0, skv, TILE):
        keys = slice(k0, k0 + TILE)
        q_lo = k0 if causal else 0
        q_hi = min(sq, k0 + TILE - 1 + window) if window > 0 else sq
        for j in range(group):
            hs = torch.arange(kvh) * group + j
            for q0 in range(q_lo // TILE * TILE, q_hi, TILE):
                rows = slice(q0, q0 + TILE)
                qt, dot = qf[:, hs, rows], dof[:, hs, rows]
                pt = probs(qt @ kf[:, :, keys].transpose(-1, -2), q0, k0,
                           lse2[:, hs, rows]).transpose(-1, -2)
                dst = pt * (vf[:, :, keys] @ dot.transpose(-1, -2) - delta[:, hs, None, rows])
                hi, lo = _hi_lo(pt)
                dv[:, :, keys] += hi @ dot + lo @ dot
                hi, lo = _hi_lo(dst)
                dk[:, :, keys] += hi @ qt + lo @ qt

    def out(t):
        return t.permute(0, 2, 1, 3).to(torch.bfloat16)

    return out(dq * scale), out(dk * scale), out(dv)


def _inputs(b, s, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)))


def _autograd(q, k, v, do, *, causal, window, dtype):
    """o, dq, dk, dv of ``nn.attention`` on q, k, v in ``dtype``."""
    xs = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
    o = nn.attention(*xs, causal=causal, window=window, chunk=4096)
    o.backward(do.to(dtype))
    return [o.detach().float()] + [x.grad.float() for x in xs]


@pytest.mark.parametrize("b,s,h,kvh,d,causal,window", CASES)
def test_k5_emulation_holds_to_f32_autograd(b, s, h, kvh, d, causal, window):
    q, k, v, do = _inputs(b, s, h, kvh, d)
    o, lse = emulate_train_forward(q, k, v, causal=causal, window=window)
    got = [o.float(), *(t.float() for t in emulate_k5(q, k, v, o, lse, do, causal=causal,
                                                       window=window))]
    ref = _autograd(q, k, v, do, causal=causal, window=window, dtype=torch.float32)
    plain = _autograd(q, k, v, do, causal=causal, window=window, dtype=torch.bfloat16)
    dv_terms = _autograd(q, k, v, do.abs(), causal=causal, window=window,
                         dtype=torch.float32)[3]  # P^T |dO|
    for name, x, r, pb in zip(("o", "dq", "dk", "dv"), got, ref, plain):
        err = (x - r).abs()
        allowed = 1e-2 * r.abs() + (2.0 ** -8 * float(r.abs().max()) if name in ("dq", "dk")
                                    else 1e-5)
        if name == "dv":
            allowed = allowed + 2.0 ** -16 * dv_terms
        rel, plain_rel = float(err.norm() / r.norm()), float((pb - r).norm() / r.norm())
        print(f"{name}: max err {float(err.max()):.3g}, relative L2 {rel:.3g} "
              f"(plain bf16 path {plain_rel:.3g})")
        assert (err <= allowed).all(), (name, float((err - allowed).max()))
        assert rel <= plain_rel, (name, rel, plain_rel)
    heads = torch.arange(h) // (h // kvh)
    scores = (q.float().permute(0, 2, 1, 3) @ k.float()[:, :, heads].permute(0, 2, 3, 1)
              ) / math.sqrt(d)
    pos = torch.arange(s)
    keep = _keep(pos, pos, s, s, causal, window)
    want = torch.logsumexp(scores.masked_fill(~keep, -math.inf), -1)
    assert float((lse - want).abs().max().detach()) <= 1e-5


# --------------------------------------------------------------------------
# which inputs take the kernels in training
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device,dtype,dq,dv,want", [
    ("cuda", torch.bfloat16, 64, 64, True),
    ("cuda", torch.bfloat16, 80, 80, True),
    ("cuda", torch.bfloat16, 128, 128, True),
    ("cpu", torch.bfloat16, 80, 80, False),  # the CPU: nn.attention
    ("cuda", torch.float32, 80, 80, False),  # f32: nn.attention
    ("cuda", torch.bfloat16, 16, 16, False),  # head dims without a training instance
    ("cuda", torch.bfloat16, 160, 160, False),
    ("cuda", torch.bfloat16, 192, 128, False),  # MLA: q/k 192 against v 128
])
def test_trains_routes_by_input(device, dtype, dq, dv, want):
    with FakeTensorMode():
        q = torch.empty(2, 64, 4, dq, dtype=dtype, device=device)
        k = torch.empty(2, 64, 2, dq, dtype=dtype, device=device)
        v = torch.empty(2, 64, 2, dv, dtype=dtype, device=device)
        assert ops.trains(q, k, v) is want


def test_trains_refuses_dtensors():
    """A DTensor (a sharded model) attends through nn.attention, even where
    its local tensors alone would take the kernels."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        with FakeTensorMode():
            q = torch.empty(1, 64, 4, 80, dtype=torch.bfloat16, device="cuda")
            kv = torch.empty(1, 64, 2, 80, dtype=torch.bfloat16, device="cuda")
            assert ops.trains(q, kv, kv)
            dq, dkv = (DTensor.from_local(t, mesh, [Replicate()]) for t in (q, kv))
            assert not ops.trains(dq, dkv, dkv)
    finally:
        dist.destroy_process_group()


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _danube_like(head_dim: int, layers: int = 2):
    """Reduced danube at a head_dim the training instances have."""
    return dataclasses.replace(get_config("h2o-danube-1.8b").reduced(), head_dim=head_dim,
                               num_layers=layers)


def _layer(cfg, device, requires_grad):
    """(attention params, x, positions) of one layer, fake, in bf16."""
    p = nn.abstract_params(transformer.attn_specs(cfg), torch.bfloat16, device)
    x = torch.empty(2, 96, cfg.d_model, dtype=torch.bfloat16, device=device,
                    requires_grad=requires_grad)
    return p, x, torch.arange(96, device=device)


def test_training_forward_dry_run_on_fake_cuda_tensors():
    """Fake bf16 CUDA tensors (a dry run) into the training entry: the
    training forward reported with its cost, an empty o, nothing launched.
    (The CPU build runs no autograd or indexing on fake CUDA tensors: the
    layer and its backward are held below on fake CPU tensors.)"""
    runtime.reset_launches()
    with FakeTensorMode():
        q = torch.empty(2, 96, 8, 80, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(2, 96, 2, 80, dtype=torch.bfloat16, device="cuda")
        assert ops.trains(q, kv, kv)
        counter = hlo_cost.OpCounter()
        counts = counter.analyze(lambda: ops.flash_attention_train(q, kv, kv, causal=True,
                                                                   window=64))
        assert counter.output.shape == q.shape and counter.output.is_cuda
    assert counts["kernel_launches"] == {"flash_attention.train_forward": 1}
    flops, _ = ops.train_cost("flash_attention.train_forward", b=2, sq=96, skv=96, h=8, kvh=2,
                              d=80, causal=True, window=64)
    assert counts["flops"] >= flops
    assert not any(runtime.LAUNCHES.values())


@pytest.fixture
def cpu_fakes_as_card(monkeypatch):
    """Fake CPU tensors stand in for a card's: the wrappers' dry branches take
    them, and training routes bf16 inputs of a training head_dim to the
    kernels, so that autograd (which the CPU build runs on CPU tensors only)
    reaches the backward's dry branch."""
    from torch._subclasses.fake_tensor import is_fake

    monkeypatch.setattr(runtime, "dry", lambda *ts: any(
        isinstance(t, torch.Tensor) and is_fake(t) for t in ts))
    monkeypatch.setattr(transformer, "trains", lambda q, k, v: (
        q.dtype == torch.bfloat16 and q.shape[-1] in kernel.TRAIN_HEAD_DIMS))


def test_training_layer_dry_run_launches_the_kernels_and_no_bmm(cpu_fakes_as_card):
    """Forward and backward of one layer through gqa_attn_forward(training=True):
    one training forward and one launch of each K5 kernel reported, and no
    batched product or softmax of nn.attention dispatched."""
    cfg = _danube_like(80)
    runtime.reset_launches()
    with FakeTensorMode():
        p, x, pos = _layer(cfg, "cpu", True)
        names = _OpNames()

        def fwd_bwd():
            with names:
                out, _ = transformer.gqa_attn_forward(cfg, p, x, pos, training=True)
                out.backward(torch.empty_like(out))
            return x.grad

        counts = hlo_cost.OpCounter().analyze(fwd_bwd)
    assert counts["kernel_launches"] == {"flash_attention.train_forward": 1,
                                         "flash_attention_bwd.dq": 1,
                                         "flash_attention_bwd.dkdv": 1}
    assert not {"aten.bmm", "aten._softmax", "aten._softmax_backward_data"} & names.names
    assert counts["dot_flops"] > 0  # the projections and their gradients
    assert not any(runtime.LAUNCHES.values())


def test_training_step_dry_run_recomputes_each_layer_forward_once(cpu_fakes_as_card):
    """The loss and its backward on fake bf16 weights of a two-layer model,
    remat "dots" (the config's): each layer's training forward runs twice
    (forward, and its recompute in backward), each K5 kernel once."""
    cfg = _danube_like(64)
    assert cfg.remat == "dots"
    with FakeTensorMode():
        params = nn.abstract_params(M.model_specs(cfg), torch.bfloat16, "cpu")
        params = nn.tree_map(lambda t: t.requires_grad_(), params)
        tokens = torch.zeros((2, 128), dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens}

        def step():
            loss, _ = M.loss_fn(cfg, params, batch)
            loss.backward()

        counts = hlo_cost.OpCounter().analyze(step)
    n = cfg.num_layers
    assert counts["kernel_launches"] == {"flash_attention.train_forward": 2 * n,
                                         "flash_attention_bwd.dq": n,
                                         "flash_attention_bwd.dkdv": n}


def test_cpu_training_attends_through_nn_attention():
    """On the CPU the training path is nn.attention's, value for value."""
    cfg = _danube_like(80)
    g = torch.Generator().manual_seed(0)
    p = nn.tree_map(lambda t: t.to(torch.bfloat16),
                    nn.init_params(transformer.attn_specs(cfg), g, torch.device("cpu")))
    x = torch.randn(2, 64, cfg.d_model, generator=g).to(torch.bfloat16)
    pos = torch.arange(64)
    out, _ = transformer.gqa_attn_forward(cfg, p, x, pos, training=True)
    q, k, v = transformer.gqa_qkv(cfg, p, x, pos)
    o = nn.attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk)
    assert torch.equal(out, nn.dense(nn.merge_last(o), p["wo"]))


def test_train_cost_counts_the_products_the_kernels_issue():
    """The training launches' FLOP: three products over the band in the
    forward (S, P_hi V, P_lo V), four in the dq kernel, six in the dk/dv
    kernel, 2 D FLOP a kept pair and q head each."""
    kw = dict(b=2, sq=4096, skv=4096, h=32, kvh=8, d=80, causal=True, window=4096)
    pairs = 4096 * 4097 // 2
    assert ops.band_pairs(4096, 4096, True, 4096) == pairs
    one = 2 * 80 * 2 * 32 * pairs  # 8.59e10: one product over danube's band
    assert round(one / 1e9) == 86
    got = {name: ops.train_cost(name, **kw)[0] for name in
           ("flash_attention.train_forward", "flash_attention_bwd.dq",
            "flash_attention_bwd.dkdv")}
    assert got == {"flash_attention.train_forward": 3 * one, "flash_attention_bwd.dq": 4 * one,
                   "flash_attention_bwd.dkdv": 6 * one}
    # bytes: q-shaped 2 x 4096 x 32 x 80, k-shaped 2 x 4096 x 8 x 80, rows 2 x 32 x 4096
    qb, kb, rows = 2 * 2 * 4096 * 32 * 80, 2 * 2 * 4096 * 8 * 80, 4 * 2 * 32 * 4096
    assert ops.train_cost("flash_attention_bwd.dkdv", **kw)[1] == 2 * qb + 4 * kb + 2 * rows


def test_training_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 64, 2, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.train_forward(q, q, q, causal=True, window=0)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.backward_dq(q, q, q, q, lse, q, causal=True, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.backward_dkdv(q, q, q, q, lse, lse, causal=True, window=0)
