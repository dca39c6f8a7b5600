"""On the card: K3's training instance and K5, the training backward, against
autograd of the plain path (``nn.attention``), the forward's recompute under
remat "dots", and danube's DaeMon step on them.  Marked ``card``: they skip
without a CUDA card, and

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_flash_attention_card.py

runs them on one.  The tolerances are tests/test_torch_flash_attention_train.py's,
whose emulation of the kernels' arithmetic meets them on the CPU:
  * o: |err| <= 1e-5 + 1e-2 |ref| (one bf16 rounding of the output);
  * dv: that, + 2^-16 (P^T |dO|) (hi + lo carries each P within 2^-17, and a
    key's dV sums up to S x group terms P dO);
  * dq and dk: |err| <= 1e-2 |ref| + 2^-8 max|ref| (delta from the bf16 o);
  * o, dq, dk, dv no further from the f32 reference in relative L2 than the
    plain path's own bf16 autograd: the same work, never fewer bits;
  * lse: |err| <= 1e-4 (the SFU's ex2.approx, 2^-22 relative a term, in l).
"""
import math

import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.models import nn

DANUBE_LAYER = (2, 4096, 32, 8, 80, True, 4096)  # the train cell's: window = S
CASES = [
    # (B, S, H, KVH, D, causal, window): head dims 64, 80 and 128, groups 1
    # and 4, windows under and over S, non-causal, S not a multiple of 64
    (1, 200, 4, 4, 64, True, 0),
    (2, 256, 8, 2, 80, True, 96),
    (1, 333, 8, 2, 80, True, 512),
    (1, 150, 4, 1, 64, True, 40),
    (1, 130, 4, 1, 64, False, 0),
    (1, 384, 4, 1, 128, True, 200),
    (2, 40, 4, 2, 80, True, 16),
    DANUBE_LAYER,
]


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the training kernels run only on the card")
    return torch.device("cuda", 0)


def _inputs(b, s, h, kvh, d, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)))


def _plain(q, k, v, do, *, causal, window, dtype):
    """o, dq, dk, dv of ``nn.attention`` on q, k, v in ``dtype``, in f32."""
    xs = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
    chunk = 1024 if q.shape[1] % 1024 == 0 else q.shape[1]
    o = nn.attention(*xs, causal=causal, window=window, chunk=chunk)
    o.backward(do.to(dtype))
    out = [o.detach().float()] + [x.grad.float() for x in xs]
    del xs, o
    return out


def _lse(q, k, *, causal, window):
    """logsumexp of the f32 scaled, masked scores, (B, H, Sq), 1024 rows at a time."""
    b, s, h, d = q.shape
    kf = torch.repeat_interleave(k.float(), h // k.shape[2], 2).permute(0, 2, 3, 1)
    kpos = torch.arange(s, device=q.device)
    out = []
    for s0 in range(0, s, 1024):
        qc = q[:, s0:s0 + 1024].float().permute(0, 2, 1, 3)
        qpos = torch.arange(s0, s0 + qc.shape[2], device=q.device)[:, None]
        keep = torch.ones(qc.shape[2], s, dtype=torch.bool, device=q.device)
        if causal:
            keep &= kpos[None] <= qpos
        if window > 0:
            keep &= kpos[None] > qpos - window
        out.append(torch.logsumexp((qc @ kf / math.sqrt(d)).masked_fill(~keep, -math.inf), -1))
    return torch.cat(out, -1)


@pytest.mark.card
@pytest.mark.parametrize("b,s,h,kvh,d,causal,window", CASES)
def test_training_kernels_match_plain_autograd(card, b, s, h, kvh, d, causal, window):
    q, k, v, do = _inputs(b, s, h, kvh, d, card)
    runtime.reset_launches()
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention_train(*xs, causal=causal, window=window)
    o.backward(do)
    torch.cuda.synchronize()
    assert {n: runtime.LAUNCHES[n] for n in ("flash_attention.train_forward",
                                             "flash_attention_bwd.dq",
                                             "flash_attention_bwd.dkdv")} == dict.fromkeys(
        ("flash_attention.train_forward", "flash_attention_bwd.dq",
         "flash_attention_bwd.dkdv"), 1)
    got = [o.detach().float()] + [x.grad.float() for x in xs]
    del xs, o
    ref = _plain(q, k, v, do, causal=causal, window=window, dtype=torch.float32)
    plain = _plain(q, k, v, do, causal=causal, window=window, dtype=torch.bfloat16)
    dv_terms = _plain(q, k, v, do.abs(), causal=causal, window=window,
                      dtype=torch.float32)[3]  # P^T |dO|
    for name, x, r, pb in zip(("o", "dq", "dk", "dv"), got, ref, plain):
        err = (x - r).abs()
        allowed = 1e-2 * r.abs() + (2.0 ** -8 * float(r.abs().max()) if name in ("dq", "dk")
                                    else 1e-5)
        if name == "dv":
            allowed = allowed + 2.0 ** -16 * dv_terms
        rel, plain_rel = float(err.norm() / r.norm()), float((pb - r).norm() / r.norm())
        print(f"{name}: max err {float(err.max()):.3g}, excess {float((err - allowed).max()):.3g}"
              f", relative L2 {rel:.3g} (plain bf16 path {plain_rel:.3g})")
        assert (err <= allowed).all(), (name, float((err - allowed).max()))
        assert rel <= plain_rel, (name, rel, plain_rel)
    del got, ref, plain, dv_terms
    _, lse = kernel.train_forward(q, k, v, causal=causal, window=window)
    lse_err = float((lse - _lse(q, k, causal=causal, window=window)).abs().max())
    print(f"lse: max err {lse_err:.3g}")
    assert lse_err <= 1e-4


@pytest.mark.card
def test_recompute_under_remat_dots_is_bit_equal(card, monkeypatch):
    """A layer under remat "dots": its training forward runs in the forward
    and again in backward, and gives the same o and lse bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=1)
    assert cfg.remat == "dots"
    calls = []
    forward = kernel.train_forward

    def recorded(*a, **kw):
        o, lse = forward(*a, **kw)
        calls.append((o.clone(), lse.clone()))
        return o, lse

    monkeypatch.setattr(kernel, "train_forward", recorded)
    g = torch.Generator(device=card).manual_seed(0)
    p = nn.tree_map(lambda t: t.to(torch.bfloat16).requires_grad_(),
                    nn.init_params(transformer.attn_specs(cfg), g, card))
    x = torch.randn(2, 2048, cfg.d_model, generator=g, device=card).to(torch.bfloat16)
    pos = torch.arange(2048, device=card)
    layer = nn.remat(lambda p, x: transformer.gqa_attn_forward(cfg, p, x, pos, training=True)[0],
                     cfg, True)
    out = layer(p, x.requires_grad_())
    out.backward(torch.randn(out.shape, generator=g, device=card).to(out.dtype))
    torch.cuda.synchronize()
    assert len(calls) == 2
    (o1, lse1), (o2, lse2) = calls
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.card
def test_danube_step_takes_the_kernels_and_never_nn_attention(card, monkeypatch):
    """danube's DaeMon step at full width and depth, B = 2 x 4096: the training
    forward 48 times (24 layers, each recomputed in backward), each K5 kernel
    24 times, K1 and K2 18 times each, K3's serving kernel and K4 never; and
    no call of nn.attention."""
    from repro_torch.configs import get_config
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    def refused(*a, **kw):
        raise AssertionError("nn.attention called in danube's training step")

    monkeypatch.setattr(nn, "attention", refused)
    cfg = get_config("h2o-danube-1.8b")
    master = nn.init_params(M.model_specs(cfg), torch.Generator(device=card).manual_seed(0),
                            card)
    state = mv.init_state(master)
    params = mv.working_copy(master, mv.DAEMON_AGGRESSIVE)
    del master
    step = steps.make_train_step(cfg, movement="daemon", movement_cfg=mv.DAEMON_AGGRESSIVE)
    g = torch.Generator(device=card).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 4097), generator=g, device=card)
    batch = {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}
    runtime.reset_launches()
    params, state, metrics = step(params, state, batch)
    loss = float(metrics["loss"])
    launches = dict(runtime.LAUNCHES)
    del params, state, step
    torch.cuda.empty_cache()
    assert math.isfinite(loss)
    assert launches == {"block_quant.quantize": 18, "block_quant.dequantize": 18,
                        "flash_attention.forward": 0, "flash_attention.train_forward": 48,
                        "flash_attention_bwd.dq": 24, "flash_attention_bwd.dkdv": 24,
                        "mamba_scan.forward": 0}, launches
