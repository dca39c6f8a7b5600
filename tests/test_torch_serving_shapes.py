"""K3's cost and capture shim at the prefill shapes of qwen3-14b, stablelm-12b
and minicpm-2b (B = 2, 8192 tokens, causal, no window), the shapes
``chip_smoke.py`` holds and times K3 at: ``ops.cost``'s FLOP, which the
bound divides by the card's bf16 peak, and ``trace_geometry`` at D = 160."""
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.launch.roofline import BF16_FLOP_PER_S

B, S = 2, 8192
PAIRS = S * (S + 1) // 2  # causal (q, k) pairs a row-batch and head: 33,558,528
# (arch, (H, KVH, D), 4·B·H·D·pairs)
SHAPES = [
    ("qwen3-14b", (40, 8, 128), 1_374_557_306_880),
    ("stablelm-12b", (32, 8, 160), 1_374_557_306_880),
    ("minicpm-2b", (36, 36, 64), 618_550_788_096),
]


@pytest.mark.parametrize("arch,heads,flop", SHAPES)
def test_cost_at_the_serving_shape(arch, heads, flop):
    cfg = get_config(arch)
    h, kvh, d = heads
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == heads
    assert d in kernel.HEAD_DIMS
    assert PAIRS == 33_558_528 == ops.band_pairs(S, S, True, 0)
    got, n_bytes = ops.cost(b=B, sq=S, skv=S, h=h, kvh=kvh, d=d, causal=True, window=0)
    assert got == flop == 4 * B * h * d * PAIRS
    # q and o in bf16, k and v at the KV heads: the bound is the FLOP's
    assert n_bytes == 2 * (2 * B * S * h * d + 2 * B * S * kvh * d)
    bound_ms = flop / BF16_FLOP_PER_S * 1e3
    assert bound_ms == pytest.approx({128: 1.390, 160: 1.390, 64: 0.625}[d], abs=5e-4)


def test_trace_geometry_takes_d160_at_stablelm_shape():
    geom = ops.trace_geometry(b=B, sq=S, skv=S, h=32, kvh=8, d=160)
    tiles = S // ops.TC_BQ
    assert geom.grid == (tiles, 32, B)
    assert geom.threads == ops.TC_THREADS and geom.ctas_per_sm == ops.TC_CTAS_PER_SM
    assert [o.shape for o in geom.operands] == [(B, S, 32, 160), (B, S, 8, 160),
                                                (B, S, 8, 160), (B, S, 32, 160)]
    assert [o.tile for o in geom.operands] == [(1, ops.TC_BQ, 1, 160), (1, ops.TC_BK, 1, 160),
                                                (1, ops.TC_BK, 1, 160), (1, ops.TC_BQ, 1, 160)]
    # CTA x walks the 64-key tiles up to its q tile's last row: 2(x'+1) for
    # the tile at x' = tiles - 1 - x, heaviest first
    steps = geom.steps
    assert len(steps) == B * 32 * tiles
    assert steps[:tiles] == tuple(2 * (tiles - x) for x in range(tiles))
    assert geom.flops_per_step == 4.0 * ops.TC_BQ * ops.TC_BK * 160
    # the tensor cores' work over every tile it visits covers the causal pairs
    assert geom.flops_per_step * sum(steps) >= 4 * B * 32 * 160 * PAIRS
