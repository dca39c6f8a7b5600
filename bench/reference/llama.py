"""Plain float32 reference of the dense decoders the cells run (Mistral's and
MiniCPM's layer equations as the port computes them), and of the DaeMon
training step around it.  Imports nothing of the port: only torch and the
frozen block quantiser beside this file.

Layer: x += Wo·attn(rope(Wq·n1(x)), rope(Wk·n1(x)), Wv·n1(x));
x += Wd·(silu(Wg·n2(x)) * Wu·n2(x)); RMSNorm in float32 with eps from the
file; rotary embedding on (first half, second half) pairs; grouped-query
attention, causal, inside the sliding window when the file has one; the
head untied or the embedding's transpose.  MiniCPM's muP scalings are not
applied, as the port applies none (the configuration file says so).

``Numerics`` says how a product with a weight is taken: exactly in float32
(the reference), or with both operands rounded to float8 e4m3 under a
per-tensor scale first (the control: the precision below the bfloat16 the
configurations state).  TF32 is switched off while the reference runs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import blockquant

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Numerics:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"numerics {kind!r}: 'f32' or 'fp8'")
        self.kind = kind

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach()  # the rounded value forward, the gradient straight through

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(x), self.round(w))


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (B, S, H, D), pos (S,): (x1, x2) halves rotated by pos·theta^(-2i/D)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: int, chunk: int = 1024):
    """Causal grouped-query attention in float32, queries in chunks, each
    against the keys its band can reach."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    outs = []
    for s0 in range(0, s, chunk):
        s1 = min(s, s0 + chunk)
        lo = max(0, s0 - window + 1) if window else 0
        qg = q[:, s0:s1].reshape(b, s1 - s0, kvh, g, d)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k[:, lo:s1]) / math.sqrt(d)
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        kpos = torch.arange(lo, s1, device=q.device)[None, :]
        keep = kpos <= qpos
        if window:
            keep &= kpos > qpos - window
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", probs, v[:, lo:s1])
                    .reshape(b, s1 - s0, h, d))
    return torch.cat(outs, dim=1)


def layers(w: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views of the stacked tensors (unbind: one stacked gradient)."""
    names = [k for k in w if k.startswith("seg0/")]
    parts = [torch.unbind(w[k], 0) for k in names]
    return [{k.rsplit("/", 1)[-1]: p[i] for k, p in zip(names, parts)}
            for i in range(len(parts[0]))]


def block(cfg, p, x, pos, num: Numerics):
    b, s, _ = x.shape
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // h
    eps = cfg["rms_norm_eps"]
    n1 = rms_norm(x, p["ln1"], eps)
    q = rope(num.mm(n1, p["wq"]).view(b, s, h, d), pos, cfg["rope_theta"])
    k = rope(num.mm(n1, p["wk"]).view(b, s, kvh, d), pos, cfg["rope_theta"])
    v = num.mm(n1, p["wv"]).view(b, s, kvh, d)
    o = attention(q, k, v, cfg.get("sliding_window") or 0)
    x = x + num.mm(o.reshape(b, s, h * d), p["wo"])
    n2 = rms_norm(x, p["ln2"], eps)
    return x + num.mm(torch.nn.functional.silu(num.mm(n2, p["w_gate"])) * num.mm(n2, p["w_up"]),
                      p["w_down"])


def hidden(cfg, w, tokens, num: Numerics, *, remat: bool = False):
    """tokens (B, S) -> the final normed hidden states (B, S, d), float32."""
    x = w["embed"][tokens.long()]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for p in layers(w):
        if remat:
            x = checkpoint(block, cfg, p, x, pos, num, use_reentrant=False)
        else:
            x = block(cfg, p, x, pos, num)
    return rms_norm(x, w["ln_f"], cfg["rms_norm_eps"])


def head(cfg, w):
    return w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]


@torch.no_grad()
def logits_rows(cfg, w, tokens, lo: int, hi: int, num: Numerics) -> torch.Tensor:
    """float32 logits (B, hi - lo, V) at positions lo..hi-1 of the full
    forward pass over ``tokens`` (B, S)."""
    with no_tf32():
        x = hidden(cfg, w, tokens, num)[:, lo:hi]
        return num.mm(x, head(cfg, w))


def _loss_chunk(x, hw, labels, num):
    logits = num.mm(x, hw)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).sum(), logz.square().sum()


def loss(cfg, w, batch, num: Numerics, z_weight: float, chunk: int = 512):
    """Mean cross-entropy over every position plus ``z_weight`` times the
    mean squared log-partition, float32 logits."""
    x = hidden(cfg, w, batch["tokens"], num, remat=True)
    hw = head(cfg, w)
    labels = batch["labels"]
    nll = z = torch.zeros((), device=x.device)
    for s0 in range(0, x.shape[1], chunk):
        a, b = checkpoint(_loss_chunk, x[:, s0:s0 + chunk], hw, labels[:, s0:s0 + chunk], num,
                          use_reentrant=False)
        nll, z = nll + a, z + b
    n = labels.numel()
    return nll / n + z_weight * z / n


def lr_at(step: int, peak_lr: float, total_steps: int, warmup_steps: int, min_ratio: float):
    """Linear warm-up from 0, then a cosine to ``min_ratio`` of the peak."""
    if step < warmup_steps:
        return peak_lr * step / warmup_steps
    frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


def train_steps(cfg, traffic, master: Dict[str, torch.Tensor], batches, num: Numerics):
    """The DaeMon step, plainly, over ``batches`` from ``master`` (path ->
    float32, updated in place): the working copy is the master, each stacked
    weight int8 round-tripped when the movement says so; the loss's float32
    gradients; each foldable gradient plus its residual crosses the link int8
    with the error fed back; AdamW with global-norm clipping and the
    schedule's lr.  -> (losses, {path: norm of the first step's gradient as
    AdamW takes it}), the master left after the last step."""
    from bench.harness.config import foldable, page_class

    mv, hp, sch = traffic["movement"], traffic["adamw"], traffic["schedule"]
    m = {k: torch.zeros_like(x) for k, x in master.items()}
    v = {k: torch.zeros_like(x) for k, x in master.items()}
    r = {k: torch.zeros_like(x) for k, x in master.items()}
    losses, first_grad = [], {}
    with no_tf32():
        for step, batch in enumerate(batches):
            work = {}
            for k, x in master.items():
                if mv["expert_weights"] == "int8" and page_class(tuple(x.shape)):
                    x = blockquant.roundtrip(x)
                work[k] = x.detach().clone().requires_grad_()
            value = loss(cfg, work, batch, num, traffic["loss"]["z_weight"])
            grads = torch.autograd.grad(value, list(work.values()))
            losses.append(float(value.detach()))
            del work, value
            with torch.no_grad():
                arrived = {}
                for (k, g) in zip(master, grads):
                    g32 = g + r[k]
                    if mv["grad_sync"] == "int8" and foldable(tuple(g.shape)):
                        arrived[k] = blockquant.roundtrip(g32)
                        r[k] = g32 - arrived[k]
                    else:
                        arrived[k] = g32
                        r[k].zero_()
                del grads
                gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in arrived.values()))
                scale = min(1.0, hp["max_grad_norm"] / (gnorm + 1e-6))
                t = step + 1
                bc1, bc2 = 1 - hp["b1"] ** t, 1 - hp["b2"] ** t
                lr = lr_at(step, traffic["peak_lr"], traffic["total_steps"],
                           sch["warmup_steps"], sch["min_ratio"])
                for k, g in arrived.items():
                    g = g * scale
                    if step == 0:
                        first_grad[k] = float(g.double().norm())
                    m[k].mul_(hp["b1"]).add_(g, alpha=1 - hp["b1"])
                    v[k].mul_(hp["b2"]).add_(g.square(), alpha=1 - hp["b2"])
                    delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + hp["eps"])
                    master[k].sub_(lr * (delta + hp["weight_decay"] * master[k]))
                del arrived
    return losses, first_grad
