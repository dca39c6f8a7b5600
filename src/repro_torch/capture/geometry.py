"""Kernel tiling geometry for trace capture (port of
``repro.capture.geometry``).

Two descriptions of a launch live here.  :class:`KernelGeometry` and
:class:`Operand` are copies of the JAX package's: a Pallas grid walked one
step at a time, each operand a BlockSpec (block shape and index map) that
tiles its array exactly.  :class:`CtaGeometry` and :class:`CtaOperand`
describe a Hopper launch instead: a CTA grid in launch order, the CTAs an SM
holds, a ragged number of steps a CTA, and per operand the tile it moves, in
the array's own layout, clipped at the array's edge as TMA and ``cp.async``
clip it (out-of-bounds elements are zero-filled and move no bytes).

Operands are laid out in disjoint, page-aligned address regions, one guard
page apart, so a replayed trace keeps which tensor a line belongs to.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from repro_torch.launch.roofline import SMS

PAGE_BYTES = 4096  # region alignment; the simulator's default page
LINE_BYTES = 64

# payload models for measured compressibility (compress.py): what byte
# distribution a region holds when the kernel runs on representative data
PAYLOADS = ("f32_dense", "f32_act_sparse", "f32_pos", "f32_scales",
            "int8_quant", "bf16_dense")


def _check_payload(name: str, payload: str) -> None:
    if payload not in PAYLOADS:
        raise ValueError(
            f"operand {name!r}: unknown payload {payload!r} (choices: {PAYLOADS})")


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


@dataclass(frozen=True)
class Operand:
    """One Pallas kernel operand: an HBM array tiled into VMEM blocks, which
    must tile it exactly; ``index_map`` maps grid indices to block indices."""

    name: str
    shape: Tuple[int, ...]  # full array shape
    block: Tuple[int, ...]  # VMEM block shape (same rank)
    index_map: Callable[..., Tuple[int, ...]]
    elem_bytes: int = 4
    is_output: bool = False
    payload: str = "f32_dense"

    def __post_init__(self):
        if len(self.shape) != len(self.block):
            raise ValueError(
                f"operand {self.name!r}: shape {self.shape} and block "
                f"{self.block} must have equal rank")
        for s, b in zip(self.shape, self.block):
            if s % b:
                raise ValueError(
                    f"operand {self.name!r}: block {self.block} must tile "
                    f"shape {self.shape} exactly")
        _check_payload(self.name, self.payload)

    @property
    def nbytes(self) -> int:
        return _prod(self.shape) * self.elem_bytes

    @property
    def block_nbytes(self) -> int:
        return _prod(self.block) * self.elem_bytes


@dataclass(frozen=True)
class KernelGeometry:
    """Grid and operands of one Pallas launch.  The grid runs minor to major,
    the last axis innermost and sequential (TPU semantics); one grid step's
    ``flops_per_step`` overlaps its block movement."""

    kernel: str
    variant: str
    grid: Tuple[int, ...]
    operands: Tuple[Operand, ...]
    flops_per_step: float = 0.0

    def __post_init__(self):
        names = [op.name for op in self.operands]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate operand names: {names}")

    @property
    def n_steps(self) -> int:
        return _prod(self.grid)

    def steps(self):
        """Grid steps in execution order (last axis fastest)."""
        return np.ndindex(*self.grid)


def assign_regions(geom) -> Dict[str, int]:
    """Operand name -> base byte address, for a :class:`KernelGeometry` or a
    :class:`CtaGeometry`.  Regions are page-aligned, sized to the operand,
    laid out in declaration order with one guard page between."""
    bases: Dict[str, int] = {}
    cursor = 0
    for op in geom.operands:
        bases[op.name] = cursor
        size = -(-op.nbytes // PAGE_BYTES) * PAGE_BYTES  # round up
        cursor += size + PAGE_BYTES  # guard page
    return bases


def _extent_line_addrs(shape: Sequence[int], elem_bytes: int, base: int,
                       start: Sequence[int], extent: Sequence[int]) -> np.ndarray:
    """Line addresses of the box ``[start, start + extent)`` of a row-major
    array at ``base``: one contiguous run along the last axis per index of
    the others, each run spanning the lines from its first to its last byte
    (a run that starts off a line boundary can cross one more)."""
    rank = len(shape)
    strides = [0] * rank
    acc = 1
    for i in range(rank - 1, -1, -1):
        strides[i] = acc
        acc *= shape[i]
    offset = sum(start[i] * strides[i] for i in range(rank))
    rows = np.zeros(1, dtype=np.int64)
    for i in range(rank - 1):
        rows = (rows[:, None] + (np.arange(extent[i]) * strides[i])[None, :]).reshape(-1)
    run_bytes = extent[-1] * elem_bytes
    run_starts = base + (offset + rows) * elem_bytes
    first = run_starts // LINE_BYTES
    last = (run_starts + run_bytes - 1) // LINE_BYTES
    counts = last - first + 1
    total = int(counts.sum())
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    lines = (np.repeat(first, counts) + within) * LINE_BYTES
    return lines.astype(np.int64)


def block_line_addrs(op: Operand, base: int, block_idx: Tuple[int, ...]) -> np.ndarray:
    """Line-granular byte addresses touched when ``block_idx`` of ``op``
    moves between HBM and VMEM: a (TR, TC) tile of an (R, C) array with
    TC < C is TR separate runs."""
    start = [i * b for i, b in zip(block_idx, op.block)]
    return _extent_line_addrs(op.shape, op.elem_bytes, base, start, op.block)


# ---------------------------------------------------------------------------
# Hopper launches
# ---------------------------------------------------------------------------

Cta = Tuple[int, int, int]  # (blockIdx.x, blockIdx.y, blockIdx.z)


@dataclass(frozen=True)
class CtaOperand:
    """One operand of a Hopper launch: the array as it lies in memory
    (row-major ``shape``), the ``tile`` one copy moves, and ``index_map``,
    which gives the tile index a CTA (its ``blockIdx``) uses at a step.

    A tile at the array's edge is clipped: only in-bounds elements move.
    An input is fetched ``ahead`` steps before the step that uses it (a
    ring of ``ahead + 1`` stages: step 0 issues steps 0..ahead, step s issues
    step s + ahead), and not again while the CTA's last fetch of it is the
    same tile (kept in shared memory or registers).  An output tile is
    written at the step that leaves it: the CTA's last step, or one whose
    next step writes another tile."""

    name: str
    shape: Tuple[int, ...]
    tile: Tuple[int, ...]
    index_map: Callable[[Cta, int], Tuple[int, ...]]
    elem_bytes: int = 4
    is_output: bool = False
    payload: str = "f32_dense"
    ahead: int = 0

    def __post_init__(self):
        if len(self.shape) != len(self.tile):
            raise ValueError(f"operand {self.name!r}: shape {self.shape} and tile "
                             f"{self.tile} must have equal rank")
        if any(t < 1 for t in self.tile):
            raise ValueError(f"operand {self.name!r}: empty tile {self.tile}")
        if self.ahead < 0 or (self.is_output and self.ahead):
            raise ValueError(f"operand {self.name!r}: ahead must be >= 0, and 0 for an output")
        _check_payload(self.name, self.payload)

    @property
    def nbytes(self) -> int:
        return _prod(self.shape) * self.elem_bytes

    def tile_extent(self, tile_idx: Tuple[int, ...]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(start, extent) of a tile, clipped to the array; raises if the
        tile starts outside it."""
        start = tuple(i * t for i, t in zip(tile_idx, self.tile))
        if any(i < 0 or s >= n for i, s, n in zip(tile_idx, start, self.shape)):
            raise ValueError(f"operand {self.name!r}: tile {tile_idx} lies outside {self.shape}")
        extent = tuple(min(t, n - s) for t, n, s in zip(self.tile, self.shape, start))
        return start, extent

    def tile_nbytes(self, tile_idx: Tuple[int, ...]) -> int:
        return _prod(self.tile_extent(tile_idx)[1]) * self.elem_bytes


def tile_line_addrs(op: CtaOperand, base: int, tile_idx: Tuple[int, ...]) -> np.ndarray:
    """Line addresses of the in-bounds part of one tile of ``op``."""
    start, extent = op.tile_extent(tile_idx)
    return _extent_line_addrs(op.shape, op.elem_bytes, base, start, extent)


@dataclass(frozen=True)
class CtaGeometry:
    """One Hopper kernel launch: the CTA ``grid`` (x, y, z), launched with
    blockIdx.x fastest; ``threads`` a CTA; ``ctas_per_sm`` resident at once
    on each of ``n_sms`` SMs; ``steps[i]`` the steps CTA i runs (ragged: a
    causal CTA skips tiles outside the band); and ``flops_per_step`` priced
    at the ``flop_unit``'s peak: "tensor" (bf16 tensor cores) or "cuda" (f32
    CUDA cores)."""

    kernel: str
    variant: str
    grid: Tuple[int, int, int]
    threads: int
    ctas_per_sm: int
    operands: Tuple[CtaOperand, ...]
    steps: Tuple[int, ...]
    flops_per_step: float
    flop_unit: str
    n_sms: int = SMS

    def __post_init__(self):
        names = [op.name for op in self.operands]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate operand names: {names}")
        if len(self.grid) != 3 or min(self.grid) < 1:
            raise ValueError(f"grid must be three positive extents, got {self.grid}")
        if len(self.steps) != self.n_ctas or min(self.steps) < 1:
            raise ValueError(f"steps must give each of the {self.n_ctas} CTAs at least one step")
        if self.ctas_per_sm < 1 or self.n_sms < 1 or self.threads < 1:
            raise ValueError("threads, ctas_per_sm and n_sms must be positive")
        if self.flop_unit not in ("tensor", "cuda"):
            raise ValueError(f"flop_unit must be 'tensor' or 'cuda', got {self.flop_unit!r}")

    @property
    def n_ctas(self) -> int:
        return _prod(self.grid)

    def cta(self, i: int) -> Cta:
        """The blockIdx of the i-th CTA in launch order."""
        gx, gy, _ = self.grid
        return i % gx, (i // gx) % gy, i // (gx * gy)
