"""The port's cost tools against the JAX package's: ``launch/roofline.py``
(the H100 terms and ``model_flops``), the op counter ``launch/hlo_cost.py``,
and the kernels' dry-run branches and ``cost()``.

  * ``model_flops`` equal to JAX's for every arch x live cell (33);
  * the reduced danube train step (baseline, B = 2, S = 128, one microbatch)
    counted on fake tensors: its matmul FLOPs equal the dot FLOPs of JAX's
    compiled step (``jax.jit(step).lower(...).compile().as_text()`` walked
    with ``repro.launch.hlo_cost``'s parser, only ``dot`` counted), which
    are 3 x (46,137,344 weight + 16,777,216 attention) + 16,777,216 for the
    attention products that ``remat="dots"`` recomputes;
  * the reduced danube prefill with the kernels' dry branch taken: the dot
    FLOPs are the weight products alone, written out from the config, and
    K3's launches are counted apart by its ``cost()``.  This CPU build of
    torch cannot run aten ops on fake CUDA tensors (its device guard has no
    CUDA), so the branch is taken on fake CPU tensors by widening
    ``runtime.dry``'s device test; on the card ``chip_smoke.py`` takes it on
    fake CUDA tensors;
  * the four wrappers on fake CUDA tensors: empty outputs of the kernels'
    shapes and dtypes, one dry launch each, no real launch; the four kernels
    raise on fake tensors before reading a pointer;
  * K3's and K4's ``cost()`` at danube's and falcon's serving shapes, as
    PERF.md section 6 gives them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_rl

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import runtime
from repro_torch.kernels.block_quant import kernel as bq_kernel
from repro_torch.kernels.block_quant import ops as bq
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_scan import kernel as ms_kernel
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.launch import hlo_cost, roofline, steps
from repro_torch.models import model as M
from repro_torch.models import nn
from repro_torch.optim import adamw

CELLS = [(a, c.name) for a in ARCHS for c in get_config(a).live_cells()]
DANUBE = "h2o-danube-1.8b"
# JAX's HLO dot FLOPs of the reduced danube train step at B = 2, S = 128
JAX_TRAIN_DOT_FLOPS = 205_520_896


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------


def test_every_live_cell_is_counted():
    assert len(CELLS) == 33


@pytest.mark.parametrize("arch,cell", CELLS)
def test_model_flops_equal_jax(arch, cell):
    from repro.configs import SHAPES as JAX_SHAPES

    from repro_torch.configs import SHAPES

    ours = roofline.model_flops(get_config(arch), SHAPES[cell])
    assert ours == jax_rl.model_flops(jax_get_config(arch), JAX_SHAPES[cell]) and ours > 0


def test_roofline_terms_over_the_h100_peaks():
    counts = {"flops": 989e12, "hbm_bytes": 2 * 3.35e12, "dot_flops": 0.0,
              "collective_bytes": {"all-reduce": 100, "all-gather": 50},
              "collective_counts": {"all-reduce": 2, "all-gather": 1}}
    rl, stats = roofline.analyze(counts, n_devices=4)
    assert stats.wire_bytes() == 250 and stats.total_operand_bytes == 150
    assert rl.t_compute == pytest.approx(1.0) and rl.t_memory == pytest.approx(2.0)
    assert rl.t_collective == pytest.approx(150 / 450e9)
    assert rl.bottleneck == "memory" and rl.t_bound == pytest.approx(2.0)
    jax_keys = set(jax_rl.Roofline(1.0, 1.0, 1.0, 1.0, 1).as_dict())
    assert set(rl.as_dict()) == jax_keys
    assert rl.as_dict()["wire_bytes"] == 250.0 and rl.as_dict()["n_devices"] == 4


def test_collective_stats_wire_bytes_as_jax():
    ob = {"all-reduce": 7, "reduce-scatter": 5, "all-to-all": 3}
    assert roofline.CollectiveStats(ob).wire_bytes() == jax_rl.CollectiveStats(ob).wire_bytes()


# --------------------------------------------------------------------------
# the op counter
# --------------------------------------------------------------------------


def _jax_dot_flops(text: str) -> float:
    """Dot FLOPs of an HLO module, loops times their trip counts: JAX's
    ``hlo_cost`` walk with only ``dot`` counted."""
    from repro.launch import hlo_cost as H

    a = H.Analyzer(text)
    memo = {}

    def walk(name):
        if name not in memo:
            comp, total = a.comps.get(name), 0.0
            for op in comp.ops if comp else ():
                if op.opcode == "dot":
                    total += a._dot_flops(comp, op)
                elif op.opcode == "while":
                    total += a._trip_count(op) * sum(
                        walk(c) for c in H._CALLED_RE.findall(op.attrs))
                elif op.opcode == "conditional":
                    m = H._BRANCH_RE.search(op.attrs)
                    names = [b.strip().lstrip("%") for b in m.group(1).split(",")] if m else []
                    total += max((walk(b) for b in names), default=0.0)
                elif op.opcode in ("fusion", "call"):
                    m = H._CALLED_RE.search(op.attrs)
                    total += walk(m.group(1)) if m else 0.0
            memo[name] = total
        return memo[name]

    return walk(a.entry)


def _jax_train_dot_flops(cfg_name: str, b: int, s: int) -> float:
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as jax_steps
    from repro.models import model as JM
    from repro.models import nn as jnn
    from repro.optim import adamw as jax_adamw

    cfg = jax_get_config(cfg_name).reduced()
    params = jnn.abstract_params(JM.model_specs(cfg), jnp.float32)
    opt = jax_adamw.init_abstract(params)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32) for k in ("tokens", "labels")}
    step = jax_steps.make_train_step(cfg, movement="baseline", num_microbatches=1)
    text = jax.jit(step).lower(params, opt, batch).compile().as_text()
    return _jax_dot_flops(text)


def _fake_train(cfg, b, s, device="cpu"):
    specs = M.model_specs(cfg)
    params = nn.abstract_params(specs, torch.float32, device)
    with nn.fake_mode():
        opt = adamw.init(params)
        batch = {k: torch.empty((b, s), dtype=torch.int32, device=device)
                 for k in ("tokens", "labels")}
    return params, opt, batch


def test_train_dot_flops_equal_jax_hlo():
    cfg = get_config(DANUBE).reduced()
    with FakeTensorMode():
        params, opt, batch = _fake_train(cfg, 2, 128)
        step = steps.make_train_step(cfg, movement="baseline", num_microbatches=1)
        counts = hlo_cost.OpCounter().analyze(step, params, opt, batch)
    assert counts["dot_flops"] == JAX_TRAIN_DOT_FLOPS
    assert counts["dot_flops"] == _jax_train_dot_flops(DANUBE, 2, 128)
    # 3 x (weights + attention) + the attention products recomputed
    assert JAX_TRAIN_DOT_FLOPS == 3 * (46_137_344 + 16_777_216) + 16_777_216
    assert counts["flops"] > counts["dot_flops"] and counts["hbm_bytes"] > 0
    assert counts["kernel_launches"] == {} and counts["collective_bytes"] == {}
    assert counts["peak_live_bytes"] > 0


class _Recorder(hlo_cost.OpCounter):
    def __init__(self):
        super().__init__()
        self.calls = []

    def kernel(self, name, flops, n_bytes):
        self.calls.append((name, flops, n_bytes))
        super().kernel(name, flops, n_bytes)


def test_prefill_dot_flops_are_the_weight_products_with_k3_apart(monkeypatch):
    monkeypatch.setattr(runtime, "dry", lambda *ts: any(
        isinstance(t, torch.Tensor) and is_fake(t) for t in ts))
    cfg = get_config(DANUBE).reduced()
    b, s = 2, 128
    runtime.reset_launches()
    with FakeTensorMode():
        params = nn.abstract_params(M.model_specs(cfg), torch.bfloat16, "cpu")
        tokens = torch.empty((b, s), dtype=torch.int32)
        counter = _Recorder()
        counts = counter.analyze(steps.make_prefill_step(cfg), params, {"tokens": tokens})
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = d * h * dh + 2 * d * kvh * dh + h * dh * d + 3 * d * cfg.d_ff
    weights = 2 * b * s * cfg.num_layers * per_layer + 2 * b * d * cfg.vocab_size  # last logits
    assert counts["dot_flops"] == weights
    k3 = fa.cost(b=b, sq=s, skv=s, h=h, kvh=kvh, d=dh, causal=True, window=cfg.window,
                 elem_bytes=2)
    assert counter.calls == [("flash_attention.forward", *k3)] * cfg.num_layers
    assert counts["kernel_launches"] == {"flash_attention.forward": cfg.num_layers}
    assert counts["flops"] >= weights + cfg.num_layers * k3[0]
    assert not any(runtime.LAUNCHES.values())


def test_counter_conventions_on_plain_ops():
    with FakeTensorMode():
        x = torch.empty(8, 16)
        w = torch.empty(16, 4)
        counts = hlo_cost.OpCounter().analyze(lambda: (x @ w).exp().sum(0).view(2, 2).t())
    out = 8 * 4
    assert counts["dot_flops"] == 2 * 8 * 16 * 4
    assert counts["flops"] == 2 * 8 * 16 * 4 + out + out * 4 / 4  # mm, exp, sum over f32
    # mm: x, w, out; exp: in, out; sum: in, out; view and t: none
    assert counts["hbm_bytes"] == 4 * ((8 * 16 + 16 * 4 + out) + 2 * out + (out + 4))
    assert counts["peak_live_bytes"] == 4 * 2 * out  # x@w beside exp; x@w is freed before sum


# --------------------------------------------------------------------------
# the kernels' dry branches and costs
# --------------------------------------------------------------------------


def test_k3_cost_at_danube_serving_shape():
    cfg = get_config(DANUBE)
    flops, n_bytes = fa.cost(b=2, sq=8192, skv=8192, h=cfg.num_heads, kvh=cfg.num_kv_heads,
                             d=cfg.head_dim, causal=True, window=cfg.window)
    assert flops == 515_438_018_560 and round(flops / 1e9) == 515  # 5.154e11
    assert n_bytes == 2 * (2 * 2 * 8192 * 32 * 80 + 2 * 2 * 8192 * 8 * 80)


def test_k4_cost_at_falcon_serving_shape():
    cfg = get_config("falcon-mamba-7b")
    flops, n_bytes = ms.cost(b=2, s=8192, d=cfg.d_inner, n=cfg.ssm_state)
    assert n_bytes == 1_345_847_296 and flops == 8 * 2 * 8192 * 8192 * 16


def test_k1_k2_cost_is_their_bytes():
    assert bq.cost("quantize", 1024, 4) == (5 * 1024, 4096 + 1024 + 32)
    assert bq.cost("dequantize", 1024, 2) == (1024, 1024 + 32 + 2048)
    with pytest.raises(ValueError):
        bq.cost("bogus", 128)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (1, 1, True, 0), (37, 37, True, 0), (130, 300, False, 0), (300, 100, True, 50),
    (256, 256, True, 16), (128, 256, False, 64),
])
def test_band_pairs_counts_the_kept_pairs(sq, skv, causal, window):
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    assert fa.band_pairs(sq, skv, causal, window) == int(keep.sum())


def _dry_case(name):
    d = "cuda"
    if name == "block_quant.quantize":
        x = torch.empty(4, 256, device=d)
        return (lambda: bq.quantize(x)), [((4, 256), torch.int8), ((4, 2), torch.float32)], \
            bq.cost("quantize", 1024, 4)
    if name == "block_quant.dequantize":
        q = torch.empty(3, 2, 128, dtype=torch.int8, device=d)
        s = torch.empty(3, 2, 1, device=d)
        return (lambda: bq.dequantize(q, s, torch.bfloat16)), [((3, 2, 128), torch.bfloat16)], \
            bq.cost("dequantize", 768, 2)
    if name == "flash_attention.forward":
        q = torch.empty(2, 40, 4, 16, dtype=torch.bfloat16, device=d)
        k = torch.empty(2, 40, 2, 16, dtype=torch.bfloat16, device=d)
        return (lambda: fa.flash_attention(q, k, k, causal=True, window=16)), \
            [((2, 40, 4, 16), torch.bfloat16)], \
            fa.cost(b=2, sq=40, skv=40, h=4, kvh=2, d=16, causal=True, window=16)
    if name.startswith(("flash_attention.train", "flash_attention_bwd")):
        q = torch.empty(2, 40, 4, 64, dtype=torch.bfloat16, device=d)
        k = torch.empty(2, 40, 2, 64, dtype=torch.bfloat16, device=d)
        lse = torch.empty(2, 4, 40, device=d)
        cost = fa.train_cost(name, b=2, sq=40, skv=40, h=4, kvh=2, d=64, causal=True, window=16)
        calls = {
            "flash_attention.train_forward": (
                lambda: fa.flash_attention_train(q, k, k, causal=True, window=16),
                [((2, 40, 4, 64), torch.bfloat16)]),
            "flash_attention_bwd.dq": (
                lambda: fa._backward_dq(q, k, k, q, lse, q, True, 16),
                [((2, 40, 4, 64), torch.bfloat16), ((2, 4, 40), torch.float32)]),
            "flash_attention_bwd.dkdv": (
                lambda: fa._backward_dkdv(q, k, k, q, lse, lse, True, 16),
                [((2, 40, 2, 64), torch.bfloat16)] * 2),
        }
        return (*calls[name], cost)
    dt = torch.empty(2, 30, 64, device=d)
    a = torch.empty(64, 8, device=d)
    bm = torch.empty(2, 30, 8, device=d)
    x = torch.empty(2, 30, 64, dtype=torch.bfloat16, device=d)
    return (lambda: ms.selective_scan(dt, a, bm, bm, x)), \
        [((2, 30, 64), torch.float32), ((2, 64, 8), torch.float32)], \
        ms.cost(b=2, s=30, d=64, n=8, x_bytes=2)


@pytest.mark.parametrize("name", sorted(runtime.LAUNCHES))
def test_dry_branch_returns_empty_outputs_and_counts_one_launch(name):
    runtime.reset_launches()
    with FakeTensorMode():
        fn, want, cost = _dry_case(name)
        counter = _Recorder()
        counter.analyze(fn)
    out = counter.output
    outs = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in outs] == want
    assert all(o.is_cuda and is_fake(o) for o in outs)
    assert counter.calls == [(name, *cost)]
    assert counter.counts()["kernel_launches"] == {name: 1}
    assert not any(runtime.LAUNCHES.values())


@pytest.mark.parametrize("name", sorted(runtime.LAUNCHES))
def test_kernel_refuses_fake_tensors(name):
    with FakeTensorMode():
        x = torch.empty(4, 256, device="cuda")
        q = torch.empty(2, 8, 2, 16, dtype=torch.bfloat16, device="cuda")
        qt = torch.empty(2, 8, 2, 64, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(2, 2, 8, device="cuda")
        f = torch.empty(1, 8, 64, device="cuda")
        a = torch.empty(64, 4, device="cuda")
        bc = torch.empty(1, 8, 4, device="cuda")
        calls = {
            "block_quant.quantize": lambda: bq_kernel.quantize(x),
            "block_quant.dequantize": lambda: bq_kernel.dequantize(
                torch.empty(4, 256, dtype=torch.int8, device="cuda"), torch.empty(4, 2,
                                                                                  device="cuda")),
            "flash_attention.forward": lambda: fa_kernel.forward(q, q, q, causal=True, window=0),
            "flash_attention.train_forward": lambda: fa_kernel.train_forward(
                qt, qt, qt, causal=True, window=0),
            "flash_attention_bwd.dq": lambda: fa_kernel.backward_dq(
                qt, qt, qt, qt, lse, qt, causal=True, window=0),
            "flash_attention_bwd.dkdv": lambda: fa_kernel.backward_dkdv(
                qt, qt, qt, qt, lse, lse, causal=True, window=0),
            "mamba_scan.forward": lambda: ms_kernel.forward(f, a, bc, bc, f),
        }
        with pytest.raises(RuntimeError, match="fake tensors have no data"):
            calls[name]()
