"""Cells at a size the CPU runs in seconds: every width cut, the traffic
shortened, the cell's own limits kept but one: the training cell's first-step
loss gap, which over 128 tokens averages the bfloat16 roundings eight times
less than over the cell's 8192 (0.3-2.1e-3 read here, several times the
cell's limit), is left out; no fault the tests plant needs it."""
import dataclasses

from bench.harness import cells

SMALL = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, vocab_size=512)
TRAIN = "danube-1.8b.train-daemon-2x4096"
PREFILL = "danube-1.8b.serve-long-prompt"
DECODE = "minicpm-2b.serve-decode-16x4k"


def small_cell(name: str):
    cell = cells.load(name)
    cfg = dict(cell.cfg, **SMALL)
    tr = dict(cell.traffic)
    limits = cell.limits
    if tr["kind"] == "train":
        cfg.update(num_key_value_heads=2, sliding_window=32)
        tr.update(batch=2, seq=64)
        limits = {"numbers": {k: v for k, v in limits["numbers"].items() if k != "loss_gap"}}
    elif tr["kind"] == "serve_batches":
        cfg.update(num_key_value_heads=2, sliding_window=32)
        tr.update(batch=2, prompt_lens=[16, 32, 48, 64], sample_requests=6, trace_units=[1, 4])
    else:
        cfg.update(num_key_value_heads=4)
        tr.update(sessions=2, history=32, turn_tokens=8, slots=40, trace_units=[2, 4])
    return dataclasses.replace(cell, cfg=cfg, traffic=tr, limits=limits)
