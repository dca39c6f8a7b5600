"""The port's training path against the JAX package on the CPU: ``loss_fn`` and
its grads, the int8 gradient fold, the DaeMon train step, microbatching, the
``train`` entry point, and the copies of the data pipeline and the fault
supervisor.

The same JAX-initialised weights (bf16 working copy), state and batches go to
both sides.  Tolerances:
  * LOSS_RTOL 1e-3 on the loss: both sides compute in bf16 with f32 softmax,
    norms and accumulation, and round at different places (the serving
    tests' logits agree to a few bf16 ulps); a loss of ~6 sums them away to
    ~1e-4 of itself.
  * GRAD_RTOL 3e-2 on each grad leaf's relative L2 distance: bf16 grads of
    bf16 activations, a few bf16 ulps (2^-8 each) apart.
  * master after the daemon steps within 2·Σlr absolute: AdamW's first steps
    move each element by about ±lr, so a tiny gradient whose sign flips
    between the two sides costs at most 2·lr a step; under 1 % of elements
    may be off by more than 0.1·Σlr.
Run with ``-s`` to print the measured distances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.configs import get_config as jax_get_config
from repro.core import movement as jax_mv
from repro.data import pipeline as jax_pipeline
from repro.kernels.block_quant import ops as jax_bq
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.models import nn as jnn
from repro.runtime import fault as jax_fault

from repro_torch.configs import get_config
from repro_torch.convert import daemon_state_from_numpy, params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.core.movement import daemon_step
from repro_torch.data import pipeline
from repro_torch.kernels import runtime
from repro_torch.kernels.block_quant import ops as bq
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.models import nn, transformer
from repro_torch.runtime import fault

jax.config.update("jax_platform_name", "cpu")

LOSS_RTOL = 1e-3
GRAD_RTOL = 3e-2
BATCH, SEQ = 2, 64  # seq 64 > the reduced window 16 and attn_chunk 32


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _batch(cfg, seed=1, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    if masked:
        labels[0, :5] = -1
        labels[1, -3:] = -1
    return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}


def _to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _master(arch, seed=0):
    cfg_j = jax_get_config(arch).reduced()
    return cfg_j, get_config(arch).reduced(), jnn.init_params(JM.model_specs(cfg_j),
                                                               jax.random.key(seed))


def _rel_l2(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# loss_fn and its grads
# --------------------------------------------------------------------------


# danube: SWA (window 16 < seq 64); minicpm: tied embeddings (and WSD);
# qwen3: qk_norm
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "minicpm-2b", "qwen3-14b"])
def test_loss_and_grads_match_jax(arch):
    cfg_j, cfg, master_j = _master(arch)
    params_j = jax_mv.working_copy(master_j, jax_mv.DAEMON_DEFAULT)
    batch = _batch(cfg)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(cfg_j, p, jax.tree.map(jnp.asarray, batch)), has_aux=True
    ))(params_j)

    params = params_from_numpy(_np(params_j), "cpu")
    grads, metrics = steps._value_and_grad(cfg, params, _to_torch(batch))

    rel = abs(float(metrics["loss"]) - float(loss_j)) / abs(float(loss_j))
    print(f"{arch}: loss {float(loss_j):.5f}, relative diff {rel:.3g} (limit {LOSS_RTOL})")
    assert rel <= LOSS_RTOL
    for key in ("ce", "tokens"):
        np.testing.assert_allclose(float(metrics[key]), float(metrics_j[key]), rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == BATCH * SEQ - 8
    ours, theirs = dict(_flat(grads)), dict(_flat(grads_j))
    assert ours.keys() == theirs.keys()
    worst = max((_rel_l2(ours[p], g), p) for p, g in theirs.items())
    for path, g_j in theirs.items():
        assert ours[path].dtype == torch.bfloat16 and tuple(ours[path].shape) == g_j.shape
        assert _rel_l2(ours[path], g_j) <= GRAD_RTOL, path
    print(f"{arch}: worst grad relative L2 {worst[0]:.3g} at {worst[1]} (limit {GRAD_RTOL})")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen3-14b"])
def test_remat_changes_no_grad_bit(arch):
    _, cfg, master_j = _master(arch)
    params = params_from_numpy(_np(jax_mv.working_copy(master_j, jax_mv.DAEMON_DEFAULT)), "cpu")
    batch = _to_torch(_batch(cfg))
    out = {}
    for remat in ("nothing", "dots", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = steps._value_and_grad(c, params, batch)
    loss, grads = out["nothing"][1]["loss"], nn.tree_leaves(out["nothing"][0])
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][1]["loss"], loss), remat
        for a, b in zip(nn.tree_leaves(out[remat][0]), grads):
            assert torch.equal(a, b), remat


def test_training_never_reaches_flash_attention(monkeypatch):
    """A dense training forward and backward attends through nn.attention,
    never through the forward-only kernel's wrapper; prefill does reach it."""
    _, cfg, master_j = _master("h2o-danube-1.8b")
    params = params_from_numpy(_np(jax_mv.working_copy(master_j, jax_mv.DAEMON_DEFAULT)), "cpu")
    batch = _to_torch(_batch(cfg))

    def refuse(*args, **kwargs):
        raise AssertionError("training called flash_attention")

    monkeypatch.setattr(transformer, "flash_attention", refuse)
    grads, metrics = steps._value_and_grad(cfg, params, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(g).all()) for g in nn.tree_leaves(grads))
    with pytest.raises(AssertionError, match="flash_attention"):
        steps.make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})


def test_kernel_wrappers_refuse_autograd():
    """The guard K3's and K4's wrappers run on CUDA inputs: a call autograd
    would differentiate raises; under no_grad, or without inputs that
    require grad, it passes."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        runtime.forward_only("flash_attention (K3)", torch.ones(2), x)
    with torch.no_grad():
        runtime.forward_only("flash_attention (K3)", x)
    runtime.forward_only("selective_scan (K4)", torch.ones(2), torch.ones(2))


# --------------------------------------------------------------------------
# the int8 gradient fold
# --------------------------------------------------------------------------


def _jax_fold(g, r):
    """The body of JAX's ``fold`` (repro/core/movement/daemon_step.py:92-99),
    a closure inside ``make_daemon_train_step``, from the same public ops."""
    g32 = g.astype(jnp.float32) + r
    if g32.ndim >= 2 and g32.shape[-1] % 128 == 0:
        q, s = jax_bq.quantize(g32)
        deq = jax_bq.dequantize(q, s, jnp.float32)
        return deq, g32 - deq
    return g32, jnp.zeros_like(g32)


def test_fold_matches_jax():
    """On identical bf16 grads and f32 residual: the codes within 1 (under
    0.1 % differing), and the arrived gradient and new residual within one
    scale step, as tests/test_kernels.py holds K1/K2."""
    rng = np.random.default_rng(3)
    shapes = [(2, 64, 256), (64, 128), (3, 64), (256,)]
    for shape in shapes:
        g = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
        r = jnp.asarray(rng.normal(size=shape) * 0.01, jnp.float32)
        deq_j, res_j = _jax_fold(g, r)
        r_t = params_from_numpy(np.asarray(r), "cpu")
        deq = daemon_step.fold(params_from_numpy(np.asarray(g), "cpu"), r_t)
        g32 = np.asarray(g.astype(jnp.float32) + r)
        if daemon_step.is_foldable(shape):
            q_j, s_j = jax_bq.quantize(jnp.asarray(g32))
            q, s = bq.quantize(torch.tensor(g32))
            dq = np.abs(q.numpy().astype(np.int32) - np.asarray(q_j, np.int32))
            assert dq.max() <= 1 and (dq > 0).mean() < 1e-3
            step = float(np.asarray(s_j).max()) * 1.01
            assert float(r_t.abs().sum()) > 0
        else:
            step = 0.0
            assert float(r_t.abs().sum()) == 0
        np.testing.assert_allclose(deq.numpy(), np.asarray(deq_j), atol=step, rtol=0)
        np.testing.assert_allclose(r_t.numpy(), np.asarray(res_j), atol=step, rtol=0)
        print(f"fold {shape}: |deq diff| {np.abs(deq.numpy() - np.asarray(deq_j)).max():.3g}, "
              f"|residual diff| {np.abs(r_t.numpy() - np.asarray(res_j)).max():.3g}")


# --------------------------------------------------------------------------
# the DaeMon train step, 3 steps from the same state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["DAEMON_DEFAULT", "DAEMON_AGGRESSIVE"])
def test_daemon_steps_match_jax(level):
    cfg_j, cfg, master_j = _master("h2o-danube-1.8b")
    n_steps = 3  # warmup 1: lr 0, then peak, then cosine's middle
    state_j = jax_mv.init_state(master_j)
    params_j = jax_mv.working_copy(master_j, getattr(jax_mv, level))
    state = daemon_state_from_numpy(_np(state_j), "cpu")
    params = mv.working_copy(state.master, getattr(mv, level))
    step_j = jax.jit(jax_steps.make_train_step(
        cfg_j, total_steps=n_steps, movement="daemon", movement_cfg=getattr(jax_mv, level)))
    step = steps.make_train_step(cfg, total_steps=n_steps, movement="daemon",
                                 movement_cfg=getattr(mv, level))
    lr_sum = 0.0
    for i in range(n_steps):
        batch = _batch(cfg, seed=10 + i)
        params_j, state_j, m_j = step_j(params_j, state_j, jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, _to_torch(batch))
        rel = abs(float(m["loss"]) - float(m_j["loss"])) / float(m_j["loss"])
        print(f"{level} step {i}: loss {float(m_j['loss']):.5f} rel diff {rel:.3g}, "
              f"lr {float(m['lr']):.3g}")
        assert rel <= LOSS_RTOL
        np.testing.assert_allclose(float(m["lr"]), float(m_j["lr"]), rtol=1e-6)
        lr_sum += float(m_j["lr"])
    assert int(state.adam.step) == int(state_j.adam.step) == n_steps

    ours, theirs = dict(_flat(state.master)), dict(_flat(state_j.master))
    worst, far = 0.0, 0
    for path, w_j in theirs.items():
        d = np.abs(_f32(ours[path]) - _f32(w_j))
        worst = max(worst, float(d.max()))
        far += int((d > 0.1 * lr_sum).sum())
    n = sum(np.asarray(w).size for w in theirs.values())
    print(f"{level}: master max |diff| {worst:.3g} (limit 2·Σlr = {2 * lr_sum:.3g}); "
          f"{far / n:.3%} beyond 0.1·Σlr")
    assert worst <= 2 * lr_sum and far / n < 1e-2

    residual = nn.tree_leaves(state.residual)
    if level == "DAEMON_DEFAULT":
        for path, w in _flat(params):
            assert torch.equal(w, dict(_flat(state.master))[path].to(torch.bfloat16)), path
        assert all(float(r.abs().sum()) == 0 for r in residual)
    else:
        assert sum(float(r.abs().sum()) for r in residual) > 0  # error feedback is live


def test_microbatches_match_one_batch():
    _, cfg, master_j = _master("minicpm-2b")
    params = params_from_numpy(_np(jax_mv.working_copy(master_j, jax_mv.DAEMON_DEFAULT)), "cpu")
    batch = _to_torch(_batch(cfg, masked=False))  # equal token counts per microbatch
    g1, m1 = steps._microbatched_grads(cfg, params, batch, 1)
    g2, m2 = steps._microbatched_grads(cfg, params, batch, 2)
    rel = abs(float(m2["loss"]) - float(m1["loss"])) / float(m1["loss"])
    assert rel <= LOSS_RTOL
    worst = 0.0
    for a, b in zip(nn.tree_leaves(g2), nn.tree_leaves(g1)):
        assert a.dtype == torch.float32
        worst = max(worst, _rel_l2(a, b))
    print(f"2 microbatches vs 1: loss rel diff {rel:.3g}, worst grad relative L2 {worst:.3g}")
    assert worst <= GRAD_RTOL
    assert float(m2["tokens"]) == BATCH * SEQ // 2  # the last microbatch's metrics


def test_microbatches_match_jax_scan():
    """k = 2 microbatches against JAX's ``lax.scan`` version
    (repro/launch/steps.py:37-60) on the same working copy and a batch with
    masked labels: the mean loss, the last microbatch's metrics, and the f32
    mean grads."""
    cfg_j, cfg, master_j = _master("h2o-danube-1.8b")
    params_j = jax_mv.working_copy(master_j, jax_mv.DAEMON_DEFAULT)
    batch = _batch(cfg)
    grads_j, m_j = jax.jit(lambda p, b: jax_steps._microbatched_grads(cfg_j, p, b, 2))(
        params_j, jax.tree.map(jnp.asarray, batch))
    grads, m = steps._microbatched_grads(cfg, params_from_numpy(_np(params_j), "cpu"),
                                         _to_torch(batch), 2)
    rel = abs(float(m["loss"]) - float(m_j["loss"])) / float(m_j["loss"])
    assert rel <= LOSS_RTOL
    assert float(m["tokens"]) == float(m_j["tokens"]) == SEQ - 3  # labels[1, -3:] masked
    ours, theirs = dict(_flat(grads)), dict(_flat(grads_j))
    assert ours.keys() == theirs.keys()
    worst = 0.0
    for path, g_j in theirs.items():
        assert ours[path].dtype == torch.float32 and tuple(ours[path].shape) == g_j.shape
        worst = max(worst, _rel_l2(ours[path], g_j))
        assert _rel_l2(ours[path], g_j) <= GRAD_RTOL, path
    print(f"k = 2 vs JAX's scan: loss rel diff {rel:.3g}, worst grad relative L2 {worst:.3g}")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "minicpm-2b", "qwen3-14b", "falcon-mamba-7b"])
def test_auto_microbatches_matches_jax(arch):
    """Same factor as JAX's for full-size configs over sequence lengths, batches
    and data-parallel widths that take it from 1 to its cap."""
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    picked = set()
    for seq in (512, 4096, 32768):
        for global_batch in (1, 4, 64):
            for n_dp in (1, 2, 8):
                k = steps.auto_microbatches(cfg, seq, global_batch, n_dp)
                assert k == jax_steps.auto_microbatches(cfg_j, seq, global_batch, n_dp)
                picked.add(k)
    assert len(picked) > 2  # the inputs reach more than one factor besides 1


# --------------------------------------------------------------------------
# the train entry point
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,movement", [("h2o-danube-1.8b", "baseline"),
                                           ("minicpm-2b", "daemon")])
def test_train_lowers_the_loss(arch, movement):
    """tests/test_substrates.py's train tests without the checkpoint: 8 steps
    of the reduced model lower the loss of what they trained on.  The hashed
    tokens are random, so each batch is new data and the per-step losses
    differ by batch-to-batch noise (~0.1) more than by training: JAX's check,
    losses[-1] < losses[0], holds or not by the draw of the init.  So the
    loss of the first batch is taken again under the returned params."""
    cfg = get_config(arch).reduced()
    params, _, losses = train(arch, reduced=True, steps=8, global_batch=4, seq_len=32,
                              movement=movement,
                              num_microbatches=2 if movement == "daemon" else 1,
                              log_every=100, device="cpu")
    pipe = pipeline.TokenPipeline(pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                                      global_batch=4, seed=0))
    first = _to_torch(pipe.batch_at(0))
    pipe.close()
    with torch.no_grad():
        after, _ = M.loss_fn(cfg, params, first)
    print(f"{arch} {movement}: losses {np.round(losses, 4).tolist()}; "
          f"first batch after training {float(after):.4f}")
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert float(after) < losses[0] - 0.05


def test_train_refuses_what_is_not_ported():
    # a mesh needs an initialised process group of its size: never unsharded
    with pytest.raises(ValueError, match=r"world size 2, have none"):
        train("h2o-danube-1.8b", steps=1, mesh_shape=(2, 1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train("h2o-danube-1.8b", steps=1)


# --------------------------------------------------------------------------
# the copies of the data pipeline and the fault supervisor
# --------------------------------------------------------------------------


def test_token_pipeline_copy_matches_jax():
    cfgs = [dict(vocab_size=256, seq_len=32, global_batch=4, seed=0),
            dict(vocab_size=32000, seq_len=64, global_batch=8, seed=7, dp_rank=1, dp_size=2)]
    for kw in cfgs:
        ours_cfg, theirs_cfg = pipeline.DataConfig(**kw), jax_pipeline.DataConfig(**kw)
        assert dataclasses.asdict(ours_cfg) == dataclasses.asdict(theirs_cfg)
        ours, theirs = pipeline.TokenPipeline(ours_cfg), jax_pipeline.TokenPipeline(theirs_cfg)
        try:
            for s in range(5):
                a, b = ours.batch_at(s), theirs.batch_at(s)
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            for _ in range(3):  # the prefetching iterator
                a, b = next(ours), next(theirs)
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert ours.state() == theirs.state() == 3
        finally:
            ours.close()
            theirs.close()


def test_fault_copy_matches_jax():
    for name in ("HeartbeatMonitor", "StragglerPolicy", "RunSupervisor"):
        ours, theirs = getattr(fault, name), getattr(jax_fault, name)
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
            (f.name, f.default) for f in dataclasses.fields(theirs)], name
    for name in ("HostState", "Action"):
        assert [(e.name, e.value) for e in getattr(fault, name)] == [
            (e.name, e.value) for e in getattr(jax_fault, name)]

    def drive(mod):
        sup = mod.RunSupervisor(hosts=[0, 1, 2, 3],
                                monitor=mod.HeartbeatMonitor(interval_s=1.0),
                                policy=mod.StragglerPolicy(rebalance_after=2, exclude_after=4,
                                                           evict_after=6))
        out = []
        for t in range(12):
            for h in (0, 1, 2):  # host 3 goes silent
                sup.monitor.beat(h, now=float(t))
            times = {0: 1.0, 1: 1.0, 2: 2.0 if t > 2 else 1.0, 3: 1.0}
            out.append(sup.tick(times, now=float(t)))
        return out, sup.events, sup.hosts, sorted(sup.excluded)

    assert drive(fault) == drive(jax_fault)
