"""The reference agrees with the port's plain paths at a small size, and its
float8 control does not."""
import pytest
import torch

from bench.harness.config import program_config, to_tree
from bench.harness.weights import draw_weights, generator, token_ids
from bench.reference import blockquant, llama
from small import DECODE, PREFILL, small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", [PREFILL, DECODE])
@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_prefill_and_decode_through_the_cache_match_the_reference(name, seed):
    """The port's prefill over 40 tokens and 7 decode steps through its grown
    cache (bfloat16 weights, activations and cache) against the float32
    reference's full forward pass.  The limit, 0.15 of the logits' spread:
    bfloat16 keeps 8 significant bits, and the roundings of two layers move
    these logits by 0.06-0.07 of their spread (0.03-0.07 measured); float8
    e4m3 keeps 3, and its control moves them by 0.6-0.8."""
    from repro_torch.core import movement as mv
    from repro_torch.launch import steps
    from repro_torch.launch.serve import _grow_cache

    cfg = small_cell(name).cfg
    pcfg = program_config(cfg)
    w32 = draw_weights(cfg, seed, CPU)
    params = to_tree({k: mv.working_copy(v, mv.DAEMON_DEFAULT) for k, v in w32.items()})
    toks = token_ids(generator(seed, "test", CPU), cfg["vocab_size"], (2, 48), CPU)
    logits, cache = steps.make_prefill_step(pcfg)(params, {"tokens": toks[:, :40]})
    cache = _grow_cache(pcfg, cache, 48)
    decode = steps.make_decode_step(pcfg)
    out = [logits]
    for i in range(40, 47):
        _, logits, cache = decode(params, cache, toks[:, i], i)
        out.append(logits)
    port = torch.stack(out, 1).float()
    ref = llama.logits_rows(cfg, w32, toks[:, :47], 39, 47, llama.Numerics("f32"))
    fp8 = llama.logits_rows(cfg, w32, toks[:, :47], 39, 47, llama.Numerics("fp8"))
    limit = 0.15 * float(ref.std())
    assert float((port - ref).abs().max()) < limit
    assert float((fp8 - ref).abs().max()) > limit


def test_the_frozen_quantiser_is_the_ports():
    from repro_torch.kernels.block_quant import ref

    x = torch.randn(6, 512, generator=torch.Generator().manual_seed(0)) * 3
    x[1] = 0
    q, s = blockquant.quantize(x)
    q2, s2 = ref.quantize_ref(x)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert torch.equal(blockquant.dequantize(q, s), ref.dequantize_ref(q2, s2))


def test_lr_schedule_is_the_ports():
    from repro_torch.optim import schedule

    fn = schedule.make("cosine", peak_lr=3e-4, total_steps=10_000, warmup_steps=100)
    for step in (0, 1, 2, 99, 100, 5000, 10_000):
        assert llama.lr_at(step, 3e-4, 10_000, 100, 0.1) == pytest.approx(float(fn(step)),
                                                                            rel=1e-6, abs=1e-12)
