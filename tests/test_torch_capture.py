"""Kernel-trace capture in the port (``repro_torch.capture``) against the JAX
package's (``repro.capture``): the copies reproduce JAX's four traces bit for
bit; the Hopper shims' constants are read from the ``.cu`` sources; the
Hopper walk's semantics (deterministic, disjoint regions, Q once a CTA, K/V
tiles exactly those of each CTA's band, clipped edge tiles, the CTA
scheduler's slot refill and ring run-ahead); the measured compressibility's
order; and a Hopper trace replayed by the JAX package's simulator from its
``.npz`` file."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port needs torch (pyproject.toml)")

import repro.capture as jax_capture
from repro.core.sim import register_trace_file, run_one
from repro.core.sim.trace import replay_slice
from repro.launch.roofline import PEAK_FLOPS as TPU_PEAK_FLOPS

from repro_torch import capture as cap
from repro_torch.capture.geometry import (
    LINE_BYTES,
    CtaGeometry,
    CtaOperand,
    KernelGeometry,
    Operand,
    assign_regions,
    block_line_addrs,
)
from repro_torch.capture.recorder import CLOCK_HZ, PEAK_BY_UNIT, CtaTraceRecorder, KernelTraceRecorder
from repro_torch.kernels.block_quant import ops as bq_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as ms_ops

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
JAX_KERNELS = ("fa_prefill", "fa_decode", "mamba_fwd", "bq_quant")
H100_KERNELS = ("fa_prefill_h100", "fa_decode_h100", "mamba_fwd_h100", "bq_quant_h100")


def _cu(name: str) -> str:
    return (KERNELS / name / "csrc" / f"{name}.cu").read_text()


def _const(src: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    return m.group(1).strip()


def _op(geom, name):
    return next(op for op in geom.operands if op.name == name)


# ---------------- the copies, held to the JAX package ----------------


@pytest.mark.parametrize("name", JAX_KERNELS)
def test_copies_reproduce_the_jax_traces(name):
    """JAX's own shim builds the TPU geometry; rebuilt field for field as
    the port's KernelGeometry and recorded by the port's recorder at JAX's
    peak, it gives JAX's trace bit for bit and JAX's compressibility."""
    jgeom = jax_capture.CAPTURED[name].build_geometry()
    geom = KernelGeometry(
        kernel=jgeom.kernel, variant=jgeom.variant, grid=tuple(jgeom.grid),
        operands=tuple(Operand(name=op.name, shape=op.shape, block=op.block,
                               index_map=op.index_map, elem_bytes=op.elem_bytes,
                               is_output=op.is_output, payload=op.payload)
                       for op in jgeom.operands),
        flops_per_step=jgeom.flops_per_step)
    ours = KernelTraceRecorder(geom, peak_flops=TPU_PEAK_FLOPS).record()
    ref = jax_capture.capture(name)
    for a, b in zip(ours.trace, ref.trace):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.moved_bytes == ref.moved_bytes
    assert ours.regions == ref.regions
    assert ours.footprint == ref.footprint
    assert cap.measured_compressibility(ours) == jax_capture.measured_compressibility_of(name)


def test_line_runs_crossing_line_boundaries_keep_every_line():
    # a 40-byte run starting at byte 40 spans lines 0 and 64, as in JAX's copy
    op = Operand("z", shape=(4, 20), block=(1, 10), elem_bytes=4,
                 index_map=lambda i, j: (i, j))
    np.testing.assert_array_equal(block_line_addrs(op, base=0, block_idx=(0, 1)), [0, 64])


def test_operand_validation():
    with pytest.raises(ValueError, match="tile shape"):
        Operand("z", shape=(4, 20), block=(3, 10), index_map=lambda i, j: (i, j))
    # a Hopper tile need not tile its array: the edge is clipped
    op = CtaOperand("z", shape=(4, 20), tile=(3, 16), index_map=lambda c, s: (1, 1))
    assert op.tile_extent((1, 1)) == ((3, 16), (1, 4))
    assert op.tile_nbytes((1, 1)) == 16
    with pytest.raises(ValueError, match="outside"):
        op.tile_extent((2, 0))
    with pytest.raises(ValueError, match="payload"):
        CtaOperand("z", (4,), (4,), lambda c, s: (0,), payload="f16")
    with pytest.raises(ValueError, match="ahead"):
        CtaOperand("z", (4,), (4,), lambda c, s: (0,), is_output=True, ahead=1)


# ---------------- drift locks: the shims against the .cu sources ----------------


def test_k3_shim_matches_its_source():
    src = _cu("flash_attention")
    consumers = int(_const(src, "kTcConsumers"))
    assert _const(src, "kTcBQ") == "64 * kTcConsumers"
    assert fa_ops.TC_BQ == 64 * consumers
    assert fa_ops.TC_BK == int(_const(src, "kTcBK"))
    assert fa_ops.TC_STAGES == int(_const(src, "kTcStages"))
    assert _const(src, "kTcThreads") == "128 * kTcConsumers + 32"
    assert fa_ops.TC_THREADS == 128 * consumers + 32
    # the launch, the heaviest-first q tile, the band and the top-left mask
    assert "dim3((Sq + kTcBQ - 1) / kTcBQ, H, B)" in src
    assert "tc_grid(a.Sq, a.H, a.B), kTcThreads, smem" in src
    assert "const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;" in src
    assert "if (p.causal) k_hi = min(p.Skv, q0 + kTcBQ);" in src
    assert "if (p.window > 0) k_lo = max(0, q0 - p.window + 1);" in src
    assert "const int t_lo = k_lo / kTcBK;" in src
    assert "const int n_tiles = max(0, (k_hi + kTcBK - 1) / kTcBK - t_lo);" in src
    assert "(!p.causal || kpos <= qpos)" in src
    assert "const int kvh = h / (p.H / p.KVH);" in src
    geom = fa_ops.trace_geometry(b=2, sq=300, skv=300, h=4, kvh=2, d=64)
    assert geom.grid == (3, 4, 2) and geom.threads == fa_ops.TC_THREADS
    assert geom.flops_per_step == 4 * fa_ops.TC_BQ * fa_ops.TC_BK * 64
    assert geom.flop_unit == "tensor"
    assert _op(geom, "k").ahead == fa_ops.TC_STAGES - 1


def test_k3_gqa_kv_head_map_matches_kernel_math():
    h, kvh = 8, 2
    geom = fa_ops.trace_geometry(b=2, sq=256, skv=256, h=h, kvh=kvh, d=64)
    k = _op(geom, "k")
    for i in range(geom.n_ctas):
        x, head, row = geom.cta(i)
        idx = k.index_map((x, head, row), 0)
        assert idx[0] == row and idx[2] == head // (h // kvh)


def test_k4_shim_matches_its_source():
    src = _cu("mamba_scan")
    threads, lanes = int(_const(src, "kThreads")), int(_const(src, "kLanes"))
    assert (ms_ops.THREADS, ms_ops.LANES) == (threads, lanes)
    assert _const(src, "kCB") == "kThreads / kLanes" and ms_ops.CB == threads // lanes
    assert ms_ops.T == int(_const(src, "kT"))
    assert ms_ops.STAGES == int(_const(src, "kStages"))
    assert "dim3((D + kCB - 1) / kCB, B)" in src
    assert "scan_kernel<TX, N><<<scan_grid(p.D, B), kThreads, smem, stream>>>" in src
    # two stages in the prologue, then stage k + kStages - 1 in chunk k
    assert "for (int s = 0; s < kStages - 1; ++s)" in src
    assert "const int kn = k + kStages - 1;" in src
    geom = ms_ops.trace_geometry(b=2, s=200, d=130, n=8)
    assert geom.grid == (3, 2, 1) and geom.threads == threads
    assert geom.steps == (4,) * 6
    assert _op(geom, "dt").ahead == ms_ops.STAGES - 1
    assert _op(geom, "x").elem_bytes == 2
    assert geom.flops_per_step == 8 * ms_ops.T * ms_ops.CB * 8 and geom.flop_unit == "cuda"


def test_k1_shim_matches_its_source():
    src = _cu("block_quant")
    assert bq_ops.BLOCK == int(_const(src, "kBlock"))
    assert bq_ops.WARPS_PER_CTA == int(_const(src, "kWarpsPerCta"))
    assert "(n_blocks + kWarpsPerCta - 1) / kWarpsPerCta" in src
    assert "<<<grid_for(n_blocks), kWarpsPerCta * 32, 0, st>>>" in src
    geom = bq_ops.trace_geometry(r=3, c=384)  # 9 blocks: 2 CTAs, the last clipped
    assert geom.grid == (2, 1, 1) and geom.threads == 32 * bq_ops.WARPS_PER_CTA
    res = CtaTraceRecorder(geom).record()
    assert res.moved_bytes == {"x": 3 * 384 * 4, "q": 3 * 384, "scales": 9 * 4}
    assert geom.flops_per_step == 5 * 1024 and geom.flop_unit == "cuda"


# ---------------- the Hopper walk ----------------


@pytest.mark.parametrize("name", H100_KERNELS)
def test_hopper_capture_is_bit_identical_on_repeat(name):
    a = cap.capture(name)
    cap.clear_capture_cache()
    b = cap.capture(name)
    assert a is not b
    for x, y in zip(a.trace, b.trace):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", H100_KERNELS)
def test_regions_disjoint_page_aligned_and_holding_every_access(name):
    res = cap.capture(name)
    geom = res.geom
    spans = sorted((res.regions[op.name], res.regions[op.name] + op.nbytes, op.name)
                   for op in geom.operands)
    for base, _, _ in spans:
        assert base % 4096 == 0
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start
    covered = np.zeros(res.n_accesses, bool)
    for lo, hi, opname in spans:
        inside = (res.addrs >= lo) & (res.addrs < hi)
        assert not (covered & inside).any()
        covered |= inside
        # an operand's region is written if and only if it is an output
        assert (res.writes[inside] == _op(geom, opname).is_output).all()
    assert covered.all()
    assert assign_regions(geom) == res.regions
    meta = cap.capture_meta(name)
    assert (meta["grid"], meta["n_accesses"], meta["footprint"]) == (
        geom.grid, res.n_accesses, res.footprint)
    assert meta["operands"] == tuple(op.name for op in geom.operands)
    assert meta["moved_bytes"] == res.moved_bytes and meta["config"] == cap.CAPTURED[name].config


@pytest.mark.parametrize("name", ("fa_prefill_h100", "fa_decode_h100"))
def test_q_fetched_once_and_o_written_once_per_cta(name):
    res = cap.capture(name)
    geom = res.geom
    cfg = cap.CAPTURED[name].config
    q_bytes = cfg["b"] * cfg["sq"] * cfg["h"] * cfg["d"] * 2
    assert res.moved_bytes["q"] == res.moved_bytes["o"] == q_bytes
    assert geom.grid[0] == -(-cfg["sq"] // fa_ops.TC_BQ)


def _band_tiles(sq, skv, causal, window):
    """KV tiles of each q tile (launch order of blockIdx.x), transcribed from
    flash_forward_wgmma_kernel: [k_lo, k_hi) in whole 64-key tiles."""
    bq, bk = 128, 64
    gx = -(-sq // bq)
    out = []
    for x in range(gx):
        q0 = (gx - 1 - x) * bq
        k_hi = min(skv, q0 + bq) if causal else skv
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        t_lo = k_lo // bk
        out.append(range(t_lo, t_lo + max(0, (k_hi + bk - 1) // bk - t_lo)))
    return out


@pytest.mark.parametrize("case", [
    (1, 300, 300, 4, 2, 64, True, 0),     # causal, ragged
    (1, 512, 512, 4, 1, 64, True, 96),    # sliding window
    (2, 100, 300, 2, 2, 128, False, 0),   # non-causal, Sq < Skv
], ids=["causal", "swa", "non_causal"])
def test_kv_fetches_are_the_band_tiles(case):
    b, sq, skv, h, kvh, d, causal, window = case
    geom = fa_ops.trace_geometry(b=b, sq=sq, skv=skv, h=h, kvh=kvh, d=d, causal=causal,
                                 window=window)
    res = CtaTraceRecorder(geom).record()
    bands = _band_tiles(sq, skv, causal, window)
    tile_bytes = sum(min(64, skv - t * 64) * d * 2 for r in bands for t in r)
    assert res.moved_bytes["k"] == res.moved_bytes["v"] == b * h * tile_bytes
    assert geom.steps == tuple(len(bands[x]) for _ in range(b * h) for x in range(len(bands)))
    # every (q, k) pair the mask keeps lies in a tile of its CTA's band
    qpos, kpos = np.arange(sq)[:, None], np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    gx = len(bands)
    for x, tiles in enumerate(bands):
        rows = slice((gx - 1 - x) * 128, (gx - x) * 128)
        needed = set(np.nonzero(keep[rows].any(axis=0))[0] // 64)
        assert needed <= set(tiles)


def test_clipped_edge_tiles_move_only_in_bounds_lines():
    # fa_decode_h100: one query row against K3's 128-row Q tile
    res = cap.capture("fa_decode_h100")
    q = _op(res.geom, "q")
    lo = res.regions["q"]
    in_q = (res.addrs >= lo) & (res.addrs < lo + q.nbytes)
    row_lines = q.shape[-1] * 2 // LINE_BYTES
    assert in_q.sum() == res.geom.n_ctas * row_lines
    assert len(np.unique(res.addrs[in_q])) == in_q.sum()  # each row's lines once


def _toy(steps, ahead=0, slots=(1, 2)):
    """One input of one line a (CTA, step) at line 16 * cta + step, and one
    output line a CTA: its trace spells out the scheduler's order."""
    n = len(steps)
    return CtaGeometry(
        kernel="toy", variant="toy", grid=(n, 1, 1), threads=32,
        ctas_per_sm=slots[1], n_sms=slots[0],
        operands=(CtaOperand("x", (n, 16, 16), (1, 1, 16), lambda c, s: (c[0], s, 0),
                             ahead=ahead),
                  CtaOperand("y", (n, 16), (1, 16), lambda c, s: (c[0], 0),
                             is_output=True)),
        steps=tuple(steps), flops_per_step=3e6, flop_unit="cuda")


def test_cta_scheduler_refills_slots_in_launch_order():
    res = CtaTraceRecorder(_toy((3, 1, 2, 1))).record()
    x = res.addrs[~res.writes] // LINE_BYTES
    order = [(int(a) // 16, int(a) % 16) for a in x]
    # two slots: CTA 1 ends in round 1 and CTA 2 takes its slot; CTAs 0 and
    # 2 end in round 3 and CTA 3 takes one
    assert order == [(0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (2, 1), (3, 0)]
    # each CTA's output is written with its last step
    y = (res.addrs - res.regions["y"]) // 64
    assert [int(a) for a in y[res.writes]] == [1, 0, 2, 3]
    steps = 3 + 1 + 2 + 1
    lump = round(3e6 / PEAK_BY_UNIT["cuda"] * CLOCK_HZ)
    assert lump > 100
    assert res.gaps.sum() == res.n_accesses - steps + steps * lump


def test_ring_runs_ahead_and_kept_tiles_are_not_fetched_again():
    res = CtaTraceRecorder(_toy((5,), ahead=2)).record()
    fetched = [int(a) // LINE_BYTES for a in res.addrs[~res.writes]]
    assert fetched == [0, 1, 2, 3, 4]
    # steps 3 and 4 issue nothing: their compute rides on the write of step 4
    lump = 3e6 / PEAK_BY_UNIT["cuda"] * CLOCK_HZ
    assert list(res.gaps[:3]) == [round(lump), 1, 1]
    assert res.gaps[-1] == round(2 * lump)


def test_block_quant_with_more_ctas_than_slots():
    r, c = 1100, 1024  # 8800 blocks: 1100 CTAs over 132 x 8 = 1056 slots
    geom = bq_ops.trace_geometry(r=r, c=c)
    assert geom.n_ctas > geom.n_sms * geom.ctas_per_sm
    res = CtaTraceRecorder(geom).record()
    x = res.addrs[(res.addrs >= res.regions["x"]) & (res.addrs < res.regions["x"] + r * c * 4)]
    np.testing.assert_array_equal(x, res.regions["x"] + 64 * np.arange(r * c * 4 // 64))
    assert res.moved_bytes == {"x": r * c * 4, "q": r * c, "scales": r * c // 128 * 4}


def test_mamba_reads_a_once_and_b_c_in_every_channel_block():
    res = cap.capture("mamba_fwd_h100")
    cfg = cap.CAPTURED["mamba_fwd_h100"].config
    b, s, d, n = cfg["b"], cfg["s"], cfg["d"], cfg["n"]
    blocks = res.geom.grid[0]
    assert res.moved_bytes == {"a": d * n * 4, "dt": b * s * d * 4, "x": b * s * d * 2,
                               "bmat": blocks * b * s * n * 4, "cmat": blocks * b * s * n * 4,
                               "y": b * s * d * 4, "h_last": b * d * n * 4}


# ---------------- measured compressibility ----------------


def test_compressibility_is_measured_and_ordered():
    comps = {name: cap.measured_compressibility_of(name) for name in H100_KERNELS}
    assert all(c >= 1.0 for c in comps.values())
    assert comps["bq_quant_h100"] > comps["fa_prefill_h100"] + 0.2
    # bf16 tiles compress more than f32 ones, less than int8 codes
    bf16, f32 = cap.measure_ratio("bf16_dense"), cap.measure_ratio("f32_dense")
    assert f32 < bf16 < cap.measure_ratio("int8_quant")
    # all four of K3's operands hold bf16: the ratio of a sample as large as q
    q_bytes = _op(cap.capture("fa_prefill_h100").geom, "q").nbytes
    assert comps["fa_prefill_h100"] == pytest.approx(cap.measure_ratio("bf16_dense", q_bytes))


# ---------------- into the JAX package's simulator ----------------


def test_npz_trace_replays_in_the_jax_simulator(tmp_path):
    path = str(tmp_path / "fa_prefill_h100.npz")
    res = cap.save_kernel_trace("fa_prefill_h100", path)
    with np.load(path) as f:
        assert sorted(f.files) == ["addrs", "compressibility", "gaps", "writes"]
        assert (f["gaps"].dtype, f["addrs"].dtype, f["writes"].dtype,
                f["compressibility"].dtype) == (np.int64, np.int64, bool, np.float64)
    spec = register_trace_file(path)
    for seed, n in ((7, 4_000), (3, res.n_accesses + 500)):
        for a, b in zip(spec(seed, 0, n), replay_slice(res.trace, seed, n)):
            np.testing.assert_array_equal(a, b)
    assert spec.compressibility == cap.measured_compressibility_of("fa_prefill_h100")
    for scheme in ("page", "daemon"):
        m = run_one(path, scheme, n_accesses=2_000)
        assert m.accesses == 2_000 and np.isfinite(m.cycles) and m.cycles > 0


def test_capture_imports_and_builds_no_kernel_library():
    code = (
        "import sys\n"
        "import repro_torch.capture as cap\n"
        "assert not [m for m in sys.modules if m.startswith('repro_torch.kernels')], "
        "sorted(m for m in sys.modules if m.startswith('repro_torch.kernels'))\n"
        "for name in cap.CAPTURED:\n"
        "    cap.capture(name)\n"
        "from repro_torch.kernels import runtime\n"
        "assert runtime._LIBS == {}, runtime._LIBS\n"
        "assert not [l for l in open('/proc/self/maps') if 'repro_torch' in l]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
