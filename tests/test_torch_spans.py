"""The model layer's attention ranges (``repro_torch.models.spans``) under
``torch.profiler`` on the CPU, at reduced sizes: ``attention.forward`` at
prefill and in the training forward (again in a layer's recompute),
``attention.backward`` round the core's backward, ``attention.decode`` in the
decode step, in every family that attends; with no profiler recording, the
same values bit for bit and no marker node in the graph.  Also: the port's
kernels launch inside a host op, to which the profiler links the launch."""
import ast
import dataclasses
import importlib
import inspect

import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import model as M
from repro_torch.models import nn, spans

SEQ = 64  # > the reduced window 16 and attn_chunk 32


def _cfg(arch: str, **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _params(cfg, requires_grad: bool = False):
    params = nn.init_params(M.model_specs(cfg), torch.Generator().manual_seed(0),
                            torch.device("cpu"), torch.bfloat16)
    return nn.tree_map(lambda x: x.requires_grad_(requires_grad), params)


def _batch(cfg, seq: int = SEQ):
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=torch.Generator().manual_seed(1))
    return {"tokens": tokens, "labels": tokens, **M.stub_inputs(cfg, tokens)}


def _attention_layers(cfg) -> int:
    """Attention cores a forward pass runs."""
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.dec_layers  # encoder; decoder self + cross
    if cfg.family == "hybrid":
        return -(-cfg.num_layers // cfg.attn_every)
    return cfg.num_layers


def _decode_cores(cfg) -> int:
    return 2 * cfg.dec_layers if cfg.family == "audio" else _attention_layers(cfg)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof.events(), out


def _ranges(events, name: str):
    return [e for e in events if e.name == name]


def _inside(e, ranges) -> bool:
    return any(r.thread == e.thread and r.time_range.start <= e.time_range.start
               and e.time_range.end <= r.time_range.end for r in ranges)


def _train_step(cfg, params, batch):
    def step():
        loss, _ = M.loss_fn(cfg, params, batch)
        with torch.profiler.record_function("test.backward"):
            loss.backward()
        return loss

    return step


@pytest.mark.parametrize("remat", ["nothing", "dots"])
def test_training_step_opens_one_forward_and_one_backward_a_layer(remat):
    cfg = _cfg("h2o-danube-1.8b", remat=remat)
    events, _ = _profiled(_train_step(cfg, _params(cfg, True), _batch(cfg)))
    (backward,) = _ranges(events, "test.backward")
    forward = _ranges(events, "attention.forward")
    first = [e for e in forward if e.time_range.end <= backward.time_range.start]
    recomputed = [e for e in forward if _inside(e, [backward])]
    assert len(first) == cfg.num_layers
    # a rematerialised layer runs its attention forward again in backward
    assert len(recomputed) == (0 if remat == "nothing" else cfg.num_layers)
    assert len(first) + len(recomputed) == len(forward)
    assert len(_ranges(events, "attention.backward")) == cfg.num_layers
    assert all(_inside(e, [backward]) for e in _ranges(events, "attention.backward"))


def test_attention_backward_holds_the_cores_products_and_softmax():
    """Every batched product and softmax backward that backward runs lies in
    an ``attention.backward`` range, or, recomputed, in ``attention.forward``;
    none of the backward range's neighbours (the weight products) does."""
    cfg = _cfg("h2o-danube-1.8b")
    events, _ = _profiled(_train_step(cfg, _params(cfg, True), _batch(cfg)))
    (backward,) = _ranges(events, "test.backward")
    attn_bwd = _ranges(events, "attention.backward")
    attn_fwd = _ranges(events, "attention.forward")
    in_backward = [e for e in events if _inside(e, [backward])]
    sm_bwd = [e for e in in_backward if e.name == "aten::_softmax_backward_data"]
    bmm = [e for e in in_backward if e.name == "aten::bmm"]
    assert sm_bwd and bmm
    assert all(_inside(e, attn_bwd) for e in sm_bwd)
    assert all(_inside(e, attn_bwd) or _inside(e, attn_fwd) for e in bmm)
    # the products of attention's backward: two a product, two products a core
    assert sum(_inside(e, attn_bwd) for e in bmm) >= 4 * cfg.num_layers
    assert not any(_inside(e, attn_bwd) for e in in_backward if e.name == "aten::mm")


# the families that attend: dense with a window, MLA with experts, the
# hybrid's shared block, the encoder-decoder (self and cross)
FAMILIES = ["h2o-danube-1.8b", "deepseek-v2-lite-16b", "zamba2-1.2b", "whisper-base"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_name_their_phase(arch):
    cfg = _cfg(arch)
    params = _params(cfg)
    batch = _batch(cfg)
    with torch.no_grad():
        events, (_, cache) = _profiled(lambda: M.prefill(cfg, params, batch))
        assert len(_ranges(events, "attention.forward")) == _attention_layers(cfg)
        assert not _ranges(events, "attention.decode")
        cache = _grow_cache(cfg, cache, SEQ + 1)
        token = batch["tokens"][:, -1]
        events, _ = _profiled(lambda: M.decode_step(cfg, params, cache, token, SEQ))
    assert len(_ranges(events, "attention.decode")) == _decode_cores(cfg)
    assert not _ranges(events, "attention.forward")
    assert not _ranges(events, "mla.attention")


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_names_forward_and_backward(arch):
    cfg = _cfg(arch, remat="nothing")
    events, _ = _profiled(_train_step(cfg, _params(cfg, True), _batch(cfg)))
    n = _attention_layers(cfg)
    assert len(_ranges(events, "attention.forward")) == n
    assert len(_ranges(events, "attention.backward")) == n
    assert not _ranges(events, "attention.decode")
    assert not _ranges(events, "mla.attention")


def _marker_nodes(root) -> int:
    seen, stack, found = set(), [root], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        found += "InBackward" in type(node).__name__
        stack.extend(f for f, _ in node.next_functions)
    return found


@pytest.mark.parametrize("arch", FAMILIES)
def test_off_path_is_bit_equal_and_adds_no_node(arch, monkeypatch):
    """Without a profiler the helper calls the core directly: loss and every
    gradient equal a run with the helper bypassed, and no marker is in the
    graph; with one recording, the markers are there and change nothing."""
    cfg = _cfg(arch)
    batch = _batch(cfg)

    def run():
        params = _params(cfg, True)
        loss, _ = M.loss_fn(cfg, params, batch)
        markers = _marker_nodes(loss.grad_fn)
        loss.backward()
        grads = [p.grad for p in nn.tree_leaves(params)]
        return loss.detach(), grads, markers

    off = run()
    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
    with monkeypatch.context() as m:
        m.setattr(spans, "attention_core", lambda fn, q, k, v, **kw: fn(q, k, v, **kw))
        bypassed = run()
    assert off[2] == 0 and bypassed[2] == 0
    assert on[2] == 2 * _attention_layers(cfg)
    for other in (on, bypassed):
        assert torch.equal(off[0], other[0])
        assert all(torch.equal(a, b) for a, b in zip(off[1], other[1]))


def test_span_is_free_when_nothing_records():
    assert not spans.recording()
    assert spans.span("attention.decode") is spans.span("attention.forward")
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
        assert isinstance(spans.span("attention.decode"), torch.profiler.record_function)


def test_launching_is_a_host_op_that_launches_link_to():
    """``record_function`` ranges are user annotations, to which the profiler
    links no launch; ``runtime.launching`` is an op of function scope, like
    an aten op, and what runs in it nests in it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with runtime.launching("flash_attention.forward"):
            torch.ones(3)
    events = prof.events()
    (op,) = _ranges(events, "repro_torch::flash_attention.forward")
    assert not op.is_user_annotation
    assert _inside(next(e for e in events if e.name == "aten::ones"), [op])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("attention.forward"):
            pass
    assert all(e.is_user_annotation for e in _ranges(prof.events(), "attention.forward"))


def _launcher_calls(tree, names):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "lib" and n.func.attr in names]


@pytest.mark.parametrize("family", ["block_quant", "flash_attention", "mamba_scan"])
def test_every_launch_runs_inside_launching(family):
    """Each wrapper's call of a launcher (a ctypes function that launches a
    kernel, not a ``*_launch`` query) sits in ``runtime.launching`` of a
    kernel ``LAUNCHES`` counts."""
    module = importlib.import_module(f"repro_torch.kernels.{family}.kernel")
    names = {fn for sigs in (module._SIGNATURES, getattr(module, "_BWD_SIGNATURES", {}))
             for fn in sigs if not fn.endswith("_launch")}
    tree = ast.parse(inspect.getsource(module))
    calls = _launcher_calls(tree, names)
    inside = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            call = item.context_expr
            if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "launching"):
                assert call.args[0].value in runtime.LAUNCHES
                inside += _launcher_calls(ast.Module(body=node.body, type_ignores=[]), names)
    assert calls and sorted(map(id, calls)) == sorted(map(id, inside))
