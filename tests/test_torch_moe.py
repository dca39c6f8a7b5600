"""The port's MoE family (deepseek-v2-lite: MLA attention, a dense first
layer, routed and shared experts; dbrx: GQA, routed experts only) against
the JAX package on the CPU: capacity and grouping, the routing and dispatch
of one group (drops included), ``apply_moe`` and its grads, MLA prefill and
absorbed decode, then the reduced models' prefill, decode, ``serve`` and its
grown cache; last, the streamed working copy that ``serve`` builds.  Training
(``loss_fn`` with its aux and grads, 3 DaeMon steps) is in
``tests/test_torch_moe_train.py``, which shares these helpers.

Parameters come from JAX's ``init_params`` (seed 0) through
``params_from_numpy``.  Tolerances: ``BF16_REL`` (four bf16 ulps of the
largest |value|) for one layer's output; ``MODEL_REL`` 2^-4 of the largest
|value| for a whole prefill's cache; ``LOGIT_TOL`` 8e-2 for logits,
``LOSS_RTOL`` 1e-3 and ``GRAD_RTOL`` 3e-2 for training: the dense and
hybrid tests' limits.  The routing of a group is held exactly: the same
experts, ranks and drops on the same x.  At model level the router sees
hidden states that already differ from JAX's by bf16 ulps, and a near-tie
can send a token to another expert: reduced dbrx's decode does so once
(JAX's probabilities 0.2425 and 0.2405, the port's 0.2410 and 0.2418), and
its logits then differ by 0.86.  So the model tests route the port as JAX
routes (``_Routes``), hold the router's probabilities within ``PROB_TOL``
of JAX's, and count where the port alone would have routed otherwise.
Run with ``-s`` to print the measured distances and counts.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from repro.configs import get_config as jax_get_config
from repro.core import movement as jax_mv
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro.models import transformer as jtransformer

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import movement as mv
from repro_torch.core.movement import daemon_step
from repro_torch.launch import steps
from repro_torch.launch.serve import _grow_cache, serve
from repro_torch.models import model as M
from repro_torch.models import moe, nn, transformer

jax.config.update("jax_platform_name", "cpu")

DEEPSEEK, DBRX = "deepseek-v2-lite-16b", "dbrx-132b"
BF16_REL = 2.0 ** -6
MODEL_REL = 2.0 ** -4
LOGIT_TOL = 8e-2
LOSS_RTOL = 1e-3
GRAD_RTOL = 3e-2
BATCH, SEQ, PROMPT, GEN = 2, 64, 32, 4
# d_model and the experts' d_ff widened to 128 so the 4-D expert stacks are
# page class: DAEMON_AGGRESSIVE takes them through the int8 round trip
WIDE = {"d_model": 128, "moe_d_ff": 128}
# the router's probabilities at model level, against JAX's on the same call:
# the hidden states differ by bf16 ulps, and after 2 DaeMon updates by the
# int8 codes that land on the other side of a rounding boundary (measured:
# 4.5e-3 in serving, 1.05e-2 in the third training step)
PROB_TOL = 2e-2


def _configs(arch, **over):
    return (dataclasses.replace(jax_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(ours, theirs, what, rel=BF16_REL):
    a, b = _f32(ours), _f32(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    print(f"{what}: max |diff| {err:.3g} at max |value| {scale:.3g}")
    assert err <= rel * scale, what


def _rel_l2(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pair(shape, seed, dtype, scale=1.0):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape) * scale, dtype)
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return x, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.fixture(scope="module", params=[DEEPSEEK, DBRX])
def model(request):
    """A reduced MoE model: JAX's bf16 working copy and the port's load of it."""
    cfg_j, cfg = _configs(request.param)
    params_j = jax_mv.working_copy(jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0)),
                                   jax_mv.DAEMON_DEFAULT)
    return request.param, cfg_j, cfg, params_j, params_from_numpy(_np(params_j), "cpu")


@pytest.fixture(scope="module")
def deepseek_layer():
    """Reduced deepseek's first MoE layer (seg1, layer 0) in bf16, both sides."""
    cfg_j, cfg = _configs(DEEPSEEK)
    params_j = jax_mv.working_copy(jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0)),
                                   jax_mv.DAEMON_DEFAULT)
    layer_j = jax.tree.map(lambda a: a[0], params_j["seg1"])
    return cfg_j, cfg, layer_j, params_from_numpy(_np(layer_j), "cpu")


# --------------------------------------------------------------------------
# capacity, groups, top-k
# --------------------------------------------------------------------------


def _jax_groups(cfg_j, tokens):
    """The length of the group scan in JAX's ``apply_moe`` (traced, not run)."""
    specs = jmoe.moe_specs(cfg_j)
    p = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16), specs,
                     is_leaf=lambda s: isinstance(s, jnn.ParamSpec))
    x = jax.ShapeDtypeStruct((1, tokens, cfg_j.d_model), jnp.bfloat16)
    jaxpr = jax.make_jaxpr(lambda p, x: jmoe.apply_moe(p, x, cfg_j))(p, x)
    return [e.params["length"] for e in jaxpr.eqns if e.primitive.name == "scan"]


@pytest.mark.parametrize("arch", [DEEPSEEK, DBRX])
def test_capacity_and_groups_match_jax(arch):
    """Over token counts from decode's t = B to the full configs' prefill
    (2 x 8192) and training (2 x 4096) batches, at full and reduced size:
    deepseek's prefill takes 4 groups of capacity 480, training 2 of 480,
    decode 1 of 8."""
    for cfg_j, cfg in ((jax_get_config(arch), get_config(arch)), _configs(arch)):
        for t in (1, 2, 7, 64, 100, 128, 192, 4095, 8192, 12288, 16384):
            assert moe._capacity(t, cfg) == jmoe._capacity(t, cfg_j), (cfg.name, t)
            g = moe.n_groups(t, cfg)
            assert t % g == 0 and moe._capacity(t // g, cfg) == jmoe._capacity(t // g, cfg_j)
        for t in (2, 100, 8192, 16384):  # traced: JAX's scan over the groups
            assert _jax_groups(cfg_j, t) == [moe.n_groups(t, cfg)], (cfg.name, t)
    cfg = get_config(DEEPSEEK)
    assert [(moe.n_groups(t, cfg), moe._capacity(t // moe.n_groups(t, cfg), cfg))
            for t in (16384, 8192, 2)] == [(4, 480), (2, 480), (1, 8)]


def test_top_k_orders_ties_as_jax():
    """Descending values, and on a tie the lower index first, as
    ``jax.lax.top_k``: rows with repeated probabilities."""
    rows = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25], [0.4, 0.1, 0.4, 0.1],
                     [0.0, 0.5, 0.0, 0.5]], np.float32)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(rows), 3)
    vals, idx = moe.top_k(torch.from_numpy(rows), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))


# --------------------------------------------------------------------------
# one dispatch group, apply_moe
# --------------------------------------------------------------------------


def _jax_routing(p, x, cfg):
    """JAX's routing of one group, as ``repro.models.moe._dispatch_group``
    (``moe.py:53-76``) computes it before the scatter: idx, pos, keep."""
    e, k = cfg.num_experts, cfg.top_k
    cap = jmoe._capacity(x.shape[0], cfg)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x.astype(jnp.float32),
                                      p["router"].astype(jnp.float32)), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    e_flat = idx.reshape(-1)
    pos_in_e = jnp.cumsum(jax.nn.one_hot(e_flat, e, dtype=jnp.int32), axis=0) - 1
    pos = jnp.take_along_axis(pos_in_e, e_flat[:, None], axis=1)[:, 0]
    pos = jnp.where(pos < cap, pos, cap)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("case", ["f32", "bf16", "bf16_capacity_0.25"])
def test_dispatch_group_matches_jax(deepseek_layer, case):
    """One group of 64 tokens: y, the aux loss, and the routing (each
    assignment's expert, rank and whether it is kept) equal JAX's on the same
    x.  At capacity factor 0.25 (C = 8 of 32 assignments an expert on
    average) assignments must drop."""
    cfg_j, cfg, layer_j, layer = deepseek_layer
    if case.endswith("0.25"):
        cfg_j, cfg = (dataclasses.replace(c, capacity_factor=0.25) for c in (cfg_j, cfg))
    dtype = jnp.float32 if case == "f32" else jnp.bfloat16
    pj, pt = layer_j["ffn"], layer["ffn"]
    xj, xt = _pair((64, cfg.d_model), 3, dtype)
    y_j, aux_j = jax.jit(lambda p, x: jmoe._dispatch_group(p, x, cfg_j))(pj, xj)
    y, aux = moe._dispatch_group(pt, xt, cfg)
    assert y.dtype == xt.dtype
    idx_j, pos_j, keep_j = _jax_routing(pj, xj, cfg_j)
    r = moe.route(pt, xt, cfg)
    np.testing.assert_array_equal(r.idx.numpy(), idx_j)
    np.testing.assert_array_equal(r.pos.numpy(), pos_j)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    dropped = int((~r.keep).sum())
    print(f"{case}: capacity {r.cap}, {dropped} of {r.keep.numel()} assignments dropped")
    assert (dropped > 0) == case.endswith("0.25")
    _close(y, y_j, f"_dispatch_group ({case}) y", BF16_REL if dtype == jnp.bfloat16 else 1e-5)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("arch", [DEEPSEEK, DBRX])
def test_apply_moe_matches_jax(arch):
    """B = 2, S = 64: t = 128 tokens in 2 groups of 64.  The output, the aux
    loss, and the grads of sum(y · c) + aux with respect to x and every
    expert, router and shared-expert leaf against ``jax.grad``."""
    cfg_j, cfg = _configs(arch)
    params_j = jax_mv.working_copy(jnn.init_params(JM.model_specs(cfg_j), jax.random.key(0)),
                                   jax_mv.DAEMON_DEFAULT)
    seg = "seg1" if cfg.first_dense_layers else "seg0"
    pj = jax.tree.map(lambda a: a[0], params_j[seg]["ffn"])
    pt = params_from_numpy(_np(pj), "cpu")
    assert ("shared_gate" in pt) == (arch == DEEPSEEK)
    xj, xt = _pair((BATCH, SEQ, cfg.d_model), 4, jnp.bfloat16)
    c = np.random.default_rng(5).normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    assert moe.n_groups(BATCH * SEQ, cfg) == 2

    def loss_j(p, x):
        y, aux = jmoe.apply_moe(p, x, cfg_j)
        return jnp.sum(y.astype(jnp.float32) * c) + aux, (y, aux)

    (_, (y_j, aux_j)), (g_pj, g_xj) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(pj, xj)
    leaves = {k: v.detach().requires_grad_() for k, v in pt.items()}
    x = xt.detach().requires_grad_()
    y, aux = moe.apply_moe(leaves, x, cfg)
    (torch.sum(y.to(torch.float32) * torch.from_numpy(c)) + aux).backward()
    _close(y, y_j, f"{arch} apply_moe y")
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), rtol=1e-6)
    assert x.grad.dtype == torch.bfloat16
    grads = {"x": (x.grad, g_xj), **{k: (leaves[k].grad, g_pj[k]) for k in pt}}
    for name, (g, g_j) in grads.items():
        rel = _rel_l2(g, g_j)
        print(f"{arch} apply_moe grad {name}: relative L2 {rel:.3g}")
        assert rel <= GRAD_RTOL, name


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------


def test_mla_forward_and_decode_match_jax(deepseek_layer):
    """Prefill over 24 positions (output and the ckv/krope cache), then
    three decode steps at positions 24-26 into a cache of 32, each against
    JAX's on the cache JAX's own steps wrote; the port writes in place."""
    cfg_j, cfg, layer_j, layer = deepseek_layer
    pj, pt = layer_j["attn"], layer["attn"]
    s, total = 24, 32
    xj, xt = _pair((BATCH, s, cfg.d_model), 6, jnp.bfloat16)
    out_j, c_j = jax.jit(lambda p, x: jtransformer.mla_attn_forward(
        cfg_j, p, x, jnp.arange(s), make_cache=True))(pj, xj)
    out, c = transformer.mla_attn_forward(cfg, pt, xt, torch.arange(s), make_cache=True)
    assert out.shape == (BATCH, s, cfg.d_model)
    _close(out, out_j, "mla_attn_forward output")
    for key in ("ckv", "krope"):
        _close(c[key], c_j[key], f"mla_attn_forward cache {key}")

    grown_j = {k: jnp.pad(v, [(0, 0), (0, total - s), (0, 0)]) for k, v in c_j.items()}
    grown = {k: params_from_numpy(np.asarray(v), "cpu") for k, v in grown_j.items()}
    decode_j = jax.jit(lambda p, x, cc, pos: jtransformer.mla_attn_decode(cfg_j, p, x, cc, pos))
    for i, pos in enumerate(range(s, s + 3)):
        xj1, xt1 = _pair((BATCH, 1, cfg.d_model), 7 + i, jnp.bfloat16)
        dec_j, grown_j = decode_j(pj, xj1, grown_j, jnp.asarray(pos, jnp.int32))
        dec, new = transformer.mla_attn_decode(cfg, pt, xt1, grown, pos)
        _close(dec, dec_j, f"mla_attn_decode output at {pos}")
        for key in ("ckv", "krope"):
            assert new[key] is grown[key]  # written in place
            _close(new[key], grown_j[key], f"mla_attn_decode {key} at {pos}")


# --------------------------------------------------------------------------
# the reduced models: prefill, decode, serve
# --------------------------------------------------------------------------


class _Routes:
    """JAX's routing, recorded from inside its jitted scans through a wrapped
    ``jax.lax.top_k`` (the MoE router is its only caller), and the port's
    router made to take JAX's experts: each call of the port's ``moe.top_k``
    takes the recorded call whose probabilities lie nearest its own (the
    same layer and group, also when a rematerialised layer routes again in
    backward), returns JAX's experts with the port's own probabilities at
    them, and tallies where the port alone would have chosen otherwise: a
    flip (an expert outside JAX's top-k) or a swap (JAX's experts in another
    order).  The probabilities must lie within ``PROB_TOL`` of JAX's, so
    either happens only where JAX's two experts lie within 2·PROB_TOL."""

    def __init__(self, monkeypatch):
        self.jax, self.flips, self.swaps, self.gap, self.dist, self.calls = [], 0, 0, 0.0, 0.0, 0
        real_j, real = jax.lax.top_k, moe.top_k

        def top_k_j(x, k):
            vals, idx = real_j(x, k)
            jax.debug.callback(lambda p, i: self.jax.append((np.asarray(p), np.asarray(i))),
                               x, idx, ordered=True)
            return vals, idx

        def top_k(probs, k):
            own = real(probs, k)[1].numpy()
            p = probs.detach().numpy()
            pj, ij = min((r for r in self.jax if r[0].shape == p.shape),
                         key=lambda r: np.abs(r[0] - p).max())
            self.dist = max(self.dist, float(np.abs(pj - p).max()))
            self.calls += 1
            for t in np.flatnonzero((own != ij).any(axis=1)):
                flips = len(set(own[t]) - set(ij[t]))
                self.flips += flips
                self.swaps += int((own[t] != ij[t]).sum()) - flips
                self.gap = max(self.gap, float(np.abs(pj[t, own[t]] - pj[t, ij[t]]).max()))
            idx = torch.from_numpy(ij.copy()).to(torch.int64)
            return probs.gather(-1, idx), idx

        monkeypatch.setattr(jax.lax, "top_k", top_k_j)
        monkeypatch.setattr(moe, "top_k", top_k)

    def jax_call(self, fn, *args):
        self.jax.clear()
        out = fn(*args)
        jax.effects_barrier()
        return out

    def report(self, what):
        print(f"{what}: {self.calls} router calls, probabilities within {self.dist:.3g} of "
              f"JAX's (limit {PROB_TOL}); the port alone would route {self.flips} assignments "
              f"to another expert and {self.swaps} in another order than JAX, where JAX's "
              f"probabilities differ by at most {self.gap:.3g}")
        assert self.dist <= PROB_TOL


def test_prefill_and_decode_match_jax(model, monkeypatch):
    """JAX's prefill and decode_step against the port's, the port fed JAX's
    greedy token at each of 4 steps and routed as JAX routes (``_Routes``)."""
    arch, cfg_j, cfg, params_j, params = model
    routes = _Routes(monkeypatch)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    logits_j, cache_j = routes.jax_call(jax.jit(lambda p, b: JM.prefill(cfg_j, p, b)),
                                        params_j, {"tokens": jnp.asarray(prompt, jnp.int32)})
    logits, cache = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.as_tensor(prompt, dtype=torch.int32)})
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    assert routes.calls == moe_layers * moe.n_groups(BATCH * PROMPT, cfg)
    routes.report(f"{arch} prefill")
    err = float(np.abs(_f32(logits) - _f32(logits_j)).max())
    print(f"{arch}: prefill logits max |diff| {err:.3g}")
    assert err <= LOGIT_TOL
    specs = dict(_flat(M.cache_specs(cfg, BATCH, PROMPT)))
    ours, theirs = dict(_flat(cache)), dict(_flat(cache_j))
    assert ours.keys() == theirs.keys() == specs.keys()
    for path, leaf in theirs.items():
        assert tuple(ours[path].shape) == specs[path].shape
        _close(ours[path], leaf, f"{arch} prefill cache {'/'.join(path)}", MODEL_REL)

    cache = _grow_cache(cfg, cache, PROMPT + GEN)
    cache_j = jax_serve._grow_cache(cfg_j, cache_j, PROMPT + GEN)
    decode_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    decode = steps.make_decode_step(cfg)
    tok_j = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    worst = 0.0
    for i in range(GEN):
        pos = PROMPT + i
        next_j, lj, cache_j = routes.jax_call(decode_j, params_j, cache_j, tok_j,
                                              jnp.asarray(pos, jnp.int32))
        next_tok, lt, cache = decode(params, cache, torch.tensor(np.asarray(tok_j)), pos)
        diff = float(np.abs(_f32(lt) - _f32(lj)).max())
        worst = max(worst, diff)
        assert diff <= LOGIT_TOL, (i, diff)
        top2 = np.sort(_f32(lj), axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL
        assert (next_tok.numpy()[clear] == np.asarray(next_j)[clear]).all()
        tok_j = next_j
    assert routes.calls == moe_layers * (moe.n_groups(BATCH * PROMPT, cfg) + GEN)
    routes.report(f"{arch} prefill and {GEN} decode steps")
    print(f"{arch}: decode logits max |diff| over {GEN} steps {worst:.3g}")


def test_serve_runs_and_grows_the_cache_as_jax(model):
    """``serve`` runs on the CPU (JAX's runs too on this family); the port's ``_grow_cache``
    pads the same leaves as JAX's (deepseek's (L, B, S, 512/64) ``ckv`` and
    ``krope`` on axis 2; dbrx's k/v), with zeros past the prompt, and the
    prompt's rows as the prefill wrote them."""
    arch, cfg_j, cfg, params_j, params = model
    r = serve(arch, reduced=True, batch=2, prompt_len=16, gen_tokens=4, device="cpu")
    assert r["tokens"].shape == (2, 4)
    assert ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size)).all()

    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, 16))
    _, cache_j = jax.jit(lambda p, b: JM.prefill(cfg_j, p, b))(
        params_j, {"tokens": jnp.asarray(prompt, jnp.int32)})
    _, cache = steps.make_prefill_step(cfg)(params, {"tokens": torch.as_tensor(prompt)})
    grown, grown_j = _grow_cache(cfg, cache, 20), jax_serve._grow_cache(cfg_j, cache_j, 20)
    keys = {"ckv", "krope"} if arch == DEEPSEEK else {"k", "v"}
    specs = dict(_flat(M.cache_specs(cfg, BATCH, 20)))
    ours, theirs = dict(_flat(grown)), dict(_flat(grown_j))
    assert ours.keys() == theirs.keys() == specs.keys() and {p[-1] for p in ours} == keys
    for path, leaf in theirs.items():
        assert tuple(ours[path].shape) == leaf.shape == specs[path].shape, path
        assert not _f32(ours[path])[:, :, 16:].any() and not _f32(leaf)[:, :, 16:].any()
        _close(ours[path], leaf, f"{arch} grown cache {'/'.join(path)}", MODEL_REL)


# --------------------------------------------------------------------------
# the streamed working copy, full-size counts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["DAEMON_DEFAULT", "DAEMON_AGGRESSIVE"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "zamba2-1.2b", DEEPSEEK])
def test_streamed_working_copy_is_the_whole_tree_copy(arch, level, monkeypatch):
    """``init_working_copy`` equals ``working_copy(init_params(...))`` bit for
    bit, leaf by leaf in the same order, and holds one drawn f32 leaf at a
    time: each is released before the next is drawn.  Deepseek is widened so
    its 4-D expert stacks are page class, zamba2 so that a Mamba2 stack is
    (reduced, it has none)."""
    widen = {DEEPSEEK: WIDE, "zamba2-1.2b": {"d_model": 128}}.get(arch, {})
    cfg = dataclasses.replace(get_config(arch).reduced(), **widen)
    specs = M.model_specs(cfg)
    whole = mv.working_copy(nn.init_params(specs, torch.Generator().manual_seed(3),
                                           torch.device("cpu")), getattr(mv, level))
    live, real = [], daemon_step._copy_leaf

    def copy_leaf(p, cfg_mv):
        assert all(ref() is None for ref in live), "an earlier drawn leaf is still alive"
        live.append(weakref.ref(p))
        return real(p, cfg_mv)

    monkeypatch.setattr(daemon_step, "_copy_leaf", copy_leaf)
    streamed = mv.init_working_copy(specs, torch.Generator().manual_seed(3), torch.device("cpu"),
                                    getattr(mv, level))
    ours, theirs = list(_flat(streamed)), list(_flat(whole))
    assert [p for p, _ in ours] == [p for p, _ in theirs] and len(live) == len(ours)
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), path
    paged = sum(daemon_step.is_page_class(tuple(t.shape)) for _, t in ours)
    assert paged > 0


def test_deepseek_counts_at_full_size():
    """Total and active parameters as JAX counts them, and the leaves the
    int8 paths move: 23 foldable gradients, 15 page-class weights (4-D
    expert stacks among them) at any depth."""
    cfg = get_config(DEEPSEEK)
    assert M.param_count(cfg) == 15_706_484_224
    assert M.param_count(cfg, active_only=True) == 2_661_150_208
    for layers in (27, 4):
        shapes = [tuple(s.shape) for s in nn.tree_leaves(
            M.model_specs(dataclasses.replace(cfg, num_layers=layers)))]
        assert sum(map(daemon_step.is_foldable, shapes)) == 23
        assert sum(map(daemon_step.is_page_class, shapes)) == 15
    specs = M.model_specs(cfg)
    assert tuple(specs["seg1"]["ffn"]["w_gate"].shape) == (26, 64, 2048, 1408)
    assert tuple(specs["seg1"]["ffn"]["w_down"].shape) == (26, 64, 1408, 2048)
