"""The NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense, at the
700 W limit), for bounds and compute gaps.  A card set below 700 W runs
slower under load: quote its ``power.limit`` beside any share of these.

The rest of ``repro.launch.roofline`` (terms read off a compiled step) is
not ported yet.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
F32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores
SMS = 132  # streaming multiprocessors
